"""Set-up: from the first line of ``run.py`` until the window opens
(imports, data, weights, the first steps or warm-up batches, and in a
fresh checkout the kernels' build)."""


def read(run):
    return run.setup_s
