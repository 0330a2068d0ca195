"""Twin of tests/test_arch_smoke.py::test_smoke_train_step_grads over every id
of the zoo, with values: the port's ``train_loss`` and the gradient of every
parameter leaf against ``jax.value_and_grad`` of the reference's on carried
weights, f32, at the reference's model-level 2e-3.  The VLM's batch carries
patch embeddings, the audio encoder's frame embeddings.

    PYTHONPATH=src python -m pytest -q tests/test_torch_zoo_grads.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

from repro.models import model as RM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.weights import _to_numpy, stack_by_reference_key  # noqa: E402
from test_torch_zoo import _carried, _close, as_jax, as_torch, smoke_batch  # noqa: E402

pytestmark = pytest.mark.slow  # compiles XLA programs, like tests/test_arch_smoke.py


@pytest.fixture(autouse=True, scope="module")
def jax_on_cpu():
    """JAX's default f32 products on a GPU are not full f32."""
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _ref_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_smoke_train_step_grads(arch):
    rcfg, tcfg, params, model = _carried(arch, seed=1, trainable=True)
    batch = smoke_batch(rcfg, 1)
    want, grads = jax.value_and_grad(RM.train_loss)(params, rcfg, as_jax(batch))
    loss = TM.train_loss(model, tcfg, as_torch(batch))
    loss.backward()
    _close(loss, want, what="loss")
    got = stack_by_reference_key(((n, p.grad) for n, p in model.named_parameters()), _to_numpy)
    assert len(got) == len(jax.tree.leaves(grads))
    for path, g in got.items():
        assert np.isfinite(g).all(), path
        _close(g, _ref_leaf(grads, path), what="/".join(path))
