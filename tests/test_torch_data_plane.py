"""The port's own copy of the DELI data plane: each copied module's source
equals the reference's but for the import rewrites (``repro.`` ->
``repro_torch.``) and the deleted ``# parity-mirror:`` marker lines (the
parity linter pairs marked regions, and a third copy would break the
reference's pairs), and the port's ``make_lm_pipeline`` yields the
reference's batches — indices and payload bytes — for two epochs on each
rank of a two-node world."""
import pathlib
import re

import pytest

pytest.importorskip("torch")

from repro.data import make_lm_pipeline as r_make_lm_pipeline  # noqa: E402
from repro_torch.data import make_lm_pipeline as t_make_lm_pipeline  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
COPIED = [f"core/{m}.py" for m in (
    "clock", "types", "bandwidth", "cache", "store", "listing_cache", "dataset", "sampler",
    "policy", "prefetcher", "lockstep", "loader", "workloads")] + [
    "engine/kernels.py", "obs/events.py", "pipeline/tiers.py", "distributed/peer_cache.py"]

_IMPORT = re.compile(r"^(\s*)(from|import) repro([. ])")
_MARKER = re.compile(r"^\s*# parity-mirror:")


def _as_copied(source: str) -> str:
    """The reference source with the two allowed changes applied."""
    lines = [line for line in source.splitlines(keepends=True) if not _MARKER.match(line)]
    return "".join(_IMPORT.sub(r"\1\2 repro_torch\3", line) for line in lines)


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_reference(rel):
    ref = (SRC / "repro" / rel).read_text(encoding="utf-8")
    port = (SRC / "repro_torch" / rel).read_text(encoding="utf-8")
    assert port == _as_copied(ref)
    assert not re.search(r"^\s*(from|import) repro[. ]", port, re.M)


def test_loader_copy_drops_exactly_its_markers():
    ref = (SRC / "repro" / "core" / "loader.py").read_text(encoding="utf-8")
    port = (SRC / "repro_torch" / "core" / "loader.py").read_text(encoding="utf-8")
    markers = [line for line in ref.splitlines() if _MARKER.match(line)]
    assert len(markers) == 6  # the sync-to, oracle-cursor and placement-install regions
    assert len(port.splitlines()) == len(ref.splitlines()) - len(markers)
    assert "parity-mirror:" not in port


def _batches(make, rank, world, epochs=2):
    loader, service, _ = make(n_samples=256, seq_len=64, vocab=512, batch_size=4,
                              cache_items=64, rank=rank, world=world)
    out = []
    with service:
        for epoch in range(epochs):
            loader.set_epoch(epoch)
            out += [(list(b.indices), [bytes(p) for p in b.payloads]) for b in loader]
    return out


@pytest.mark.slow  # threaded pipeline on a real (fast-forwarded) clock
@pytest.mark.parametrize("rank", [0, 1])
def test_lm_pipeline_yields_reference_batches(rank):
    want = _batches(r_make_lm_pipeline, rank, world=2)
    got = _batches(t_make_lm_pipeline, rank, world=2)
    assert len(got) == 2 * 256 // 2 // 4
    assert got == want
