"""The port's spans (``repro_torch/obs/spans.py``): nothing without a
profiler; under one, the spans of a training step and of a ``generate``
call at the layer boundaries, nested and sharing their root's id; results
bitwise the same with the profiler on and off; each profiling session read
apart; and the benchmark's span readers at toy size."""
import dataclasses
import os
import sys
import threading
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
from torch.profiler import ProfilerActivity, profile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # the benchmark's readers, at the repository's root
    sys.path.insert(0, ROOT)

from bench_port import harness  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import PrefetchConfig, RealClock  # noqa: E402
from repro_torch.data import decode_tokens, make_lm_pipeline  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.models.model import DecoderLM  # noqa: E402
from repro_torch.obs import spans  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402
from repro_torch.training.loop import Trainer, TrainerConfig  # noqa: E402
from repro_torch.training.optimizer import OptSettings  # noqa: E402

SEQ, BATCH = 32, 2
LM = ArchConfig(name="lm-spans", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab=256, dtype="float32", attn_chunk=16)
STEP_CHILDREN = ["train.next_batch", "train.batch_to_device", "train.forward", "train.backward",
                 "train.optimizer", "train.sync"]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, {e.name for e in prof.events()}


def _trainer():
    loader, service, _ = make_lm_pipeline(
        n_samples=64, seq_len=SEQ, vocab=LM.vocab, batch_size=BATCH, cache_items=16,
        policy=PrefetchConfig.fifty_fifty(16), clock=RealClock(),
    )
    t = Trainer(LM, loader, TrainerConfig(seq_len=SEQ, batch_size=BATCH, log_every=1000), decode_tokens,
                settings=OptSettings(lr=3e-3, moment_dtype="float32"), device="cpu")
    return t, service


def _engine(arch):
    cfg = dataclasses.replace(configs.reduce_for_smoke(configs.get(arch)), dtype="float32")
    return cfg, ServeEngine(cfg, DecoderLM.from_config(cfg, seed=0, device="cpu"), max_len=64, device="cpu")


def _prompts(vocab, B=3, L=40, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, L)).tolist()


def _inside(events):
    """Every span lies inside its parent's interval and carries its root's id."""
    by_id = {e.attr("id"): e for e in events}
    for e in events:
        if e.attr("parent") == 0:
            assert e.attr("root") == e.attr("id")
            continue
        p = by_id[e.attr("parent")]
        assert e.attr("root") == p.attr("root")
        assert p.t <= e.t and e.t + e.dur <= p.t + p.dur, (p, e)


def _reader(name):
    return harness.metric(name).read(None)


def test_span_off_opens_nothing():
    before = (len(spans.RECORDER.events), len(spans.RECORDER.unresolved))
    with mock.patch.object(torch.profiler, "record_function", side_effect=AssertionError("range opened")), \
            mock.patch.object(torch.cuda, "Event", side_effect=AssertionError("event created")), \
            mock.patch.object(torch.cuda, "synchronize", side_effect=AssertionError("synchronised")):
        assert spans.span("a", x=1) is spans.span("b")
        with spans.span("a", x=1):
            with spans.span("b"):
                pass
    assert (len(spans.RECORDER.events), len(spans.RECORDER.unresolved)) == before


def test_span_on_is_a_profiler_range_with_ids():
    def work():
        with spans.span("outer", n=3):
            with spans.span("inner"):
                torch.ones(4).sum()
    _, names = _profiled(work)
    assert {"repro_torch::outer", "repro_torch::inner"} <= names
    outer, inner = spans.by_root("outer")[0]
    assert (outer.kind, inner.kind) == ("outer", "inner")
    assert outer.attr("n") == 3 and inner.attr("parent") == outer.attr("id")
    assert inner.attr("device_s") == inner.dur  # on the CPU the device time is the host's
    _inside([outer, inner])


def test_leaf_span_opens_no_range():
    def work():
        with spans.span("outer"):
            with spans.leaf_span("leaf", k=1):
                torch.ones(4).sum()
    _, names = _profiled(work)
    assert "repro_torch::outer" in names and "repro_torch::leaf" not in names
    outer, leaf = spans.by_root("outer")[0]
    assert leaf.kind == "leaf" and leaf.attr("parent") == outer.attr("id") and leaf.attr("k") == 1


def test_thread_with_no_open_span_joins_the_newest_root():
    """As autograd's backward threads do: their spans belong to the step."""
    def work():
        with spans.span("root"):
            with spans.span("waiting"):
                th = threading.Thread(target=lambda: spans.span("elsewhere").__enter__().__exit__(None, None, None))
                th.start()
                th.join(timeout=10)
                assert not th.is_alive()
    _profiled(work)
    root, waiting, elsewhere = spans.by_root("root")[0]
    assert elsewhere.kind == "elsewhere" and elsewhere.attr("parent") == waiting.attr("id")
    assert elsewhere.attr("root") == root.attr("id")


def test_recorder_keeps_the_newest():
    rec = spans.SpanRecorder(capacity=8)
    with mock.patch.object(spans, "RECORDER", rec):
        def work():
            for i in range(20):
                with spans.span("s", i=i):
                    pass
        _profiled(work)
        assert [e.attr("i") for e in rec.latest()] == list(range(12, 20))


@pytest.mark.slow  # threaded pipeline on a real clock, like tests/test_torch_training_loop.py
def test_trainer_steps_under_profiler():
    t, svc = _trainer()
    with svc:
        t.train(1)  # off: the set-up a job runs before it is profiled
        _, names = _profiled(lambda: t.train(2))
    steps = spans.by_root("train.step")
    assert [s[0].attr("step") for s in steps] == [2, 3]
    for step in steps:
        root = step[0]
        assert root.attr("tokens") == SEQ * BATCH
        children = [e.kind for e in step if e.attr("parent") == root.attr("id")]
        assert children == STEP_CHILDREN
        _inside(step)
        mixers = [e for e in step if e.kind == "model.mixer"]
        assert {e.attr("layer") for e in mixers} == {0, 1}  # the forward's and the backward's recomputation
    assert {"repro_torch::" + k for k in ["train.step"] + STEP_CHILDREN} <= names
    for name in ("forward_ms.train", "backward_ms.train", "optimizer_ms.train", "between_steps_ms.train"):
        assert _reader(name) > 0, name


@pytest.mark.slow
def test_one_step_has_no_gap_between_steps():
    t, svc = _trainer()
    with svc:
        t.train(1)
        _profiled(lambda: t.train(1))
    assert len(spans.by_root("train.step")) == 1
    assert _reader("between_steps_ms.train") is None and _reader("forward_ms.train") > 0


@pytest.mark.slow
def test_training_bitwise_with_profiler_on_and_off():
    params = []
    for on in (False, True):
        t, svc = _trainer()
        with svc:
            if on:
                _profiled(lambda: t.train(2))
            else:
                t.train(2)
        params.append({k: v.detach().clone() for k, v in t.params.named_parameters()})
    assert params[0].keys() == params[1].keys()
    assert all(torch.equal(params[0][k], params[1][k]) for k in params[0])


# the kernel spans of one layer, in order, where it launches more than its main kernel
LAYER_KERNELS = {"kernel.ssd_scan": ["kernel.ssm_conv", "kernel.ssd_scan", "kernel.ssm_gate_norm"]}


@pytest.mark.parametrize("arch,kernel", [("h2o-danube-3-4b", "kernel.flash_attention"),
                                         ("mamba2-130m", "kernel.ssd_scan")])
def test_generate_spans(arch, kernel):
    layer_kernels = LAYER_KERNELS.get(kernel, [kernel])
    cfg, engine = _engine(arch)
    engine.generate(_prompts(cfg.vocab), max_new_tokens=1)  # off
    _, names = _profiled(lambda: [engine.generate(_prompts(cfg.vocab, seed=s), max_new_tokens=2) for s in (2, 3)])
    batches = spans.by_root("serve.generate")
    assert [b[0].attr("batch") for b in batches] == [2, 3]
    for b in batches:
        root = b[0]
        assert (root.attr("requests"), root.attr("prompt_tokens")) == (3, 3 * 40)
        _inside(b)
        by_id = {e.attr("id"): e for e in b}
        mixers = [e for e in b if e.kind == "model.mixer"]
        assert sorted(e.attr("layer") for e in mixers) == list(range(cfg.n_layers))
        assert {e.attr("mixer") for e in mixers} == set(cfg.period)
        kernels = [e for e in b if e.kind.startswith("kernel.")]
        assert [e.kind for e in kernels] == layer_kernels * cfg.n_layers
        assert all(by_id[e.attr("parent")].kind == "model.mixer" for e in kernels)
        for m in mixers:
            own = sum(e.attr("device_s") for e in kernels if e.attr("parent") == m.attr("id"))
            assert m.attr("device_s") - own >= 0
        assert [e.kind for e in b if e.attr("parent") == root.attr("id")][0] == "serve.prompts_to_device"
    assert {"repro_torch::serve.generate", "repro_torch::model.mixer"} <= names
    # leaf spans: a range around an entry keeps its kernels
    assert not {"repro_torch::" + k for k in layer_kernels} & names
    assert _reader("prompts_to_device_ms.prefill") > 0
    assert _reader("mixer_self_ms.prefill") > 0
    mlp = _reader("mlp_ms.prefill")
    assert (mlp > 0) if "mlp" in cfg.mlp_pattern else mlp is None


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "mamba2-130m"])
def test_served_tokens_bitwise_with_profiler_on_and_off(arch):
    cfg, engine = _engine(arch)
    prompts = _prompts(cfg.vocab, seed=4)
    off = engine.generate(prompts, max_new_tokens=3)
    on, _ = _profiled(lambda: engine.generate(prompts, max_new_tokens=3))
    assert on.tokens == off.tokens
    assert off.prefill_s > 0 and off.decode_s > 0


def test_a_second_run_reads_only_its_own_spans():
    """A session starts at the first span seen on after one seen off or
    after a read: a run's set-up, off, parts it from the run before, and so
    does reading the run before."""
    cfg, first = _engine("mamba2-130m")
    first.generate(_prompts(cfg.vocab), max_new_tokens=1)
    _profiled(lambda: [first.generate(_prompts(cfg.vocab), max_new_tokens=1) for _ in range(2)])
    assert len(spans.by_root("serve.generate")) == 2
    assert len(spans.by_root("serve.generate")) == 2  # a read reads the same session again
    _, second = _engine("mamba2-130m")
    second.generate(_prompts(cfg.vocab), max_new_tokens=1)  # its set-up, off
    _profiled(lambda: second.generate(_prompts(cfg.vocab), max_new_tokens=1))
    (batch,) = spans.by_root("serve.generate")
    assert batch[0].attr("batch") == 2
    _profiled(lambda: second.generate(_prompts(cfg.vocab), max_new_tokens=1))  # straight after the read
    (batch,) = spans.by_root("serve.generate")
    assert batch[0].attr("batch") == 3
    assert {e.attr("session") for e in spans.RECORDER.latest()} == {spans.RECORDER.session}
    assert _reader("forward_ms.train") is None  # no step in this session


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engine's timing events and the spans' device times are the card's")
    return torch.device("cuda")


def test_cuda_generate_reads_its_times_without_synchronising(cuda):
    cfg = dataclasses.replace(configs.reduce_for_smoke(configs.get("h2o-danube-3-4b")), dtype="float32",
                              use_kernels=False)
    engine = ServeEngine(cfg, DecoderLM.from_config(cfg, seed=0, device=cuda), max_len=64, device=cuda)
    prompts = _prompts(cfg.vocab)
    engine.generate(prompts, max_new_tokens=1)
    with mock.patch.object(torch.cuda, "synchronize", side_effect=AssertionError("synchronised")):
        res = engine.generate(prompts, max_new_tokens=3)
    assert res.prefill_s > 0 and res.decode_s > 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        engine.generate(prompts, max_new_tokens=1)
    (batch,) = spans.by_root("serve.generate")
    mixers = [e for e in batch if e.kind == "model.mixer"]
    assert len(mixers) == cfg.n_layers and all(e.attr("device_s") > 0 for e in mixers)
