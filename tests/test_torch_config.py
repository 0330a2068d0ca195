"""The port's configs against the reference's, and the port's import rule:
``repro_torch`` and ``chip_smoke.py`` never import JAX or ``repro``."""
import ast
import dataclasses
import pathlib

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro import configs as rconfigs  # noqa: E402
from repro.models import config as rconfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


def _pair(arch, smoke):
    r, t = rconfigs.get(arch), tconfigs.get(arch)
    if smoke:
        r, t = rconfigs.reduce_for_smoke(r), tconfigs.reduce_for_smoke(t)
    return r, t


def test_arch_ids_equal():
    assert tconfigs.ARCH_IDS == rconfigs.ARCH_IDS
    assert list(tconfigs.all_configs()) == list(rconfigs.all_configs())
    with pytest.raises(KeyError):
        tconfigs.get("no-such-arch")


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_config_fields_equal(arch, smoke):
    r, t = _pair(arch, smoke)
    want, got = dataclasses.asdict(r), dataclasses.asdict(t)
    # the one rename: use_pallas -> use_kernels, in the same place
    names_r = [f.name for f in dataclasses.fields(r)]
    names_t = [f.name for f in dataclasses.fields(t)]
    assert names_t == [("use_kernels" if n == "use_pallas" else n) for n in names_r]
    want.pop("use_pallas")
    assert got.pop("use_kernels") is True
    assert got == want
    assert str(t.torch_dtype) == f"torch.{r.jnp_dtype.name}"
    for prop in ("n_periods", "d_inner", "ssm_heads", "has_attention", "has_ssm",
                 "is_encoder", "subquadratic"):
        assert getattr(t, prop) == getattr(r, prop), prop


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_param_counts_equal(arch, smoke):
    r, t = _pair(arch, smoke)
    assert t.param_count() == r.param_count()
    assert t.active_param_count() == r.active_param_count()
    assert [s.name for s in tconfig.applicable_shapes(t)] == [
        s.name for s in rconfig.applicable_shapes(r)
    ]


def test_shape_cells_equal():
    assert [dataclasses.asdict(s) for s in tconfig.ALL_SHAPES] == [
        dataclasses.asdict(s) for s in rconfig.ALL_SHAPES
    ]
    assert tconfig.LONG_500K.tokens_per_step == rconfig.LONG_500K.tokens_per_step


def test_config_validation_matches():
    for bad in (dict(period=("attn", "ssm")), dict(period=("conv",), mlp_pattern=("mlp",)),
                dict(n_layers=3, period=("attn", "attn"), mlp_pattern=("mlp", "mlp"))):
        base = dict(name="x", family="dense", n_layers=2, d_model=8, n_heads=2, d_ff=8, vocab=8)
        base.update(bad)
        with pytest.raises(ValueError):
            rconfig.ArchConfig(**base)
        with pytest.raises(ValueError):
            tconfig.ArchConfig(**base)


def _port_sources():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _bad_imports(path, root=REPO):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.relative_to(root)}:{node.lineno}: {name}")
    return bad


def test_port_never_imports_jax_or_reference():
    files = _port_sources()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = [b for f in files for b in _bad_imports(f)]
    assert bad == [], "\n".join(bad)


def test_import_checker_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom repro.models import model\n"
                   "import repro_torch\nfrom repro_torch.models import layers\n")
    bad = _bad_imports(src, root=tmp_path)
    assert bad == ["m.py:1: jax.numpy", "m.py:2: repro.models"]
