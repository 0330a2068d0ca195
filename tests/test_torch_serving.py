"""The port's serving engine: twins of tests/test_serving.py on the dense
archs, mamba2-130m, phi3.5-moe and the hybrid jamba (its SSM state and conv
tail beside attention K/V in one cache), greedy tokens equal to the
reference engine's exactly on carried weights, and the device rule (the card
unless the caller asks for the CPU).  As in tests/test_serving.py, the MoE
configs run at capacity_factor 16, which drops no token."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

from repro import configs as rconfigs  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serving import ServeEngine as RefEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402
from repro_torch.weights import params_from_reference  # noqa: E402

pytestmark = pytest.mark.slow  # compiles XLA programs, like tests/test_serving.py

DENSE = ["internlm2-20b", "h2o-danube-3-4b"]
PORTED = DENSE + ["mamba2-130m", "phi3.5-moe-42b-a6.6b", "jamba-1.5-large-398b"]


def _smoke(configs, arch):
    """tests/test_serving.py:17-19: f32, and a capacity that drops no token."""
    return dataclasses.replace(configs.reduce_for_smoke(configs.get(arch)), dtype="float32",
                               capacity_factor=16.0)


def _engine(arch, seed=0):
    cfg = _smoke(tconfigs, arch)
    model = TM.DecoderLM.from_config(cfg, seed=seed, device="cpu")
    return cfg, model, ServeEngine(cfg, model, max_len=64, device="cpu")


def _prompts(vocab, B, L, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, L)).tolist()


@pytest.mark.parametrize("arch", PORTED)
def test_generate_matches_manual_decode(arch):
    cfg, model, engine = _engine(arch)
    B, L, N = 2, 16, 6
    prompts = _prompts(cfg.vocab, B, L)
    res = engine.generate(prompts, max_new_tokens=N)
    assert all(len(t) == N for t in res.tokens)

    # manual loop: prefill then N-1 greedy decode steps
    with torch.inference_mode():
        logits, (caches, kv_len) = TM.prefill(model, cfg, {"tokens": torch.tensor(prompts)})
        # grow only K/V (axis 2), as the reference's test does; an SSM
        # position's state and conv tail have no sequence axis
        caches = {pos: {k: (torch.nn.functional.pad(v, (0, 0, 0, 0, 0, N)) if k in ("k", "v") else v)
                        for k, v in sub.items()}
                  for pos, sub in caches.items()}
        state = (caches, kv_len)
        tok = torch.argmax(logits, -1)[:, None]
        manual = [tok[:, 0].numpy()]
        for step in range(N - 1):
            logits, state = TM.decode_step(model, cfg, tok, state, L + step)
            tok = torch.argmax(logits, -1)[:, None]
            manual.append(tok[:, 0].numpy())
    np.testing.assert_array_equal(np.asarray(res.tokens), np.stack(manual, 1))
    assert res.prefill_s >= 0 and res.decode_s >= 0 and res.total_new_tokens == B * N


@pytest.mark.parametrize("arch", PORTED)
def test_greedy_tokens_equal_reference_engine(arch):
    rcfg, tcfg = _smoke(rconfigs, arch), _smoke(tconfigs, arch)
    params = RM.init_params(jax.random.PRNGKey(5), rcfg)
    model = params_from_reference(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    prompts = _prompts(rcfg.vocab, 3, 20, seed=2)
    want = RefEngine(rcfg, params, max_len=64).generate(prompts, max_new_tokens=10)
    got = ServeEngine(tcfg, model, max_len=64, device="cpu").generate(prompts, max_new_tokens=10)
    assert got.tokens == want.tokens


def test_sampled_generation_is_seeded():
    cfg, _, engine = _engine("h2o-danube-3-4b")
    prompts = _prompts(cfg.vocab, 2, 8)
    a = engine.generate(prompts, max_new_tokens=5, greedy=False, seed=7)
    b = engine.generate(prompts, max_new_tokens=5, greedy=False, seed=7)
    assert a.tokens == b.tokens
    assert all(0 <= t < cfg.vocab for seq in a.tokens for t in seq)


def test_generate_rejects_ragged_prompts():
    _, _, engine = _engine("internlm2-20b")
    with pytest.raises(ValueError):
        engine.generate([[1, 2, 3], [1, 2]], max_new_tokens=2)


def test_encoder_has_no_engine():
    cfg = tconfigs.reduce_for_smoke(tconfigs.get("hubert-xlarge"))
    with pytest.raises(ValueError):
        ServeEngine(cfg, {}, max_len=8)


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is taken, not refused")
    cfg, model, _ = _engine("internlm2-20b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, model, max_len=64)


def test_serve_batched_example_smoke(capsys):
    from repro_torch.examples import serve_batched

    res = serve_batched.main(["--smoke", "--device", "cpu"])
    assert [len(t) for t in res.tokens] == [16] * 4
    assert "on CPU" in capsys.readouterr().out
