"""SSD chunk 256 (jamba-1.5-large's ``ssm_chunk``) and the sub-tile rule of
the Hopper SSD kernels, against the reference.

The kernels take a chunk longer than 128 as ``chunk / ssd_tile(chunk)``
sub-tiles with the chunk's a_cum and the state carried between them
(``repro_torch/kernels/ssd.py``).  The CUDA kernels cannot run here, so that
arithmetic is held in plain PyTorch (``sub_tile_scan``) against the Pallas
kernel (interpret mode) at the chunk length.  Then the plain version and the model's chunked
path at chunk 256, the tile rule itself, and one SSM block on a jamba-ratio
config with chunk 256.  Tolerances are the reference's: 2e-4 (f32) and 2e-2
(bf16) for the SSD functions (tests/test_kernels.py:106), 2e-3 for the
block.  Then the widths past the zoo's (P 80 and 128, N 136 and 256): the
plain version and the kernels' P tiles and 64-row sub-tiles against the
Pallas kernel, and the tile rule at those widths.  On a card, the kernels
themselves at chunk 256 against their plain version, and the raise past N
256 (the kernels at the wide widths: tests/test_torch_kernels.py).

    PYTHONPATH=src python -m pytest -q tests/test_torch_ssd_chunk.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ssd as SSD  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

pytestmark = pytest.mark.slow  # XLA interpret-mode kernels, like tests/test_kernels.py

SSD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
BLOCK_TOL = 2e-3
B, S, H, P, G, N = 1, 512, 2, 16, 1, 16  # two chunks of 256


@pytest.fixture(autouse=True, scope="module")
def jax_on_cpu():
    """JAX's default f32 products on a GPU are not full f32."""
    with jax.default_device(jax.devices("cpu")[0]):
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


def ssd_inputs(seed, B, S, H, P, G, N):
    """x, dt, A, B, C, D as numpy f32, drawn like tests/test_kernels.py's."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))  # softplus
    A = -np.exp(rng.standard_normal(H) * 0.3)
    Bm = rng.standard_normal((B, S, G, N))
    Cm = rng.standard_normal((B, S, G, N))
    D = 1.0 + 0.1 * rng.standard_normal(H)
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm, D)]


def _pair(arrays, dtype, device="cpu"):
    """(jax args, torch args): x/B/C in ``dtype``; dt, A and D f32."""
    jargs, targs = [], []
    for i, a in enumerate(arrays):
        dt = dtype if i in (0, 3, 4) else "float32"
        jargs.append(jnp.asarray(a).astype(getattr(jnp, dt)))
        targs.append(torch.from_numpy(a).to(device=device, dtype=getattr(torch, dt)))
    return jargs, targs


def _close(got, want, tol, what=""):
    got = got.detach().float().cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["ssd_scan_plain", "ssd_chunked"])
def test_chunk256_matches_pallas_and_reference_chunked(fn, dtype):
    """The kernel's plain version and the model's chunked path at chunk 256,
    against the Pallas kernel at chunk 256 and the reference's chunked path."""
    jargs, targs = _pair(ssd_inputs(0, B, S, H, P, G, N), dtype)
    f = SSD.ssd_scan_plain if fn == "ssd_scan_plain" else TS.ssd_chunked
    y, st = f(*targs, chunk=256)
    assert tuple(y.shape) == (B, S, H, P) and tuple(st.shape) == (B, H, P, N)
    assert st.dtype == torch.float32
    tol = SSD_TOL[dtype]
    for name, (want_y, want_st) in (
        ("pallas", rops.ssd_scan(*jargs, chunk=256, interpret=True)),
        ("reference ssd_chunked", RS.ssd_chunked(*jargs, chunk=256)),
    ):
        _close(y, want_y, tol, f"y against {name}")
        _close(st, want_st, tol, f"state against {name}")


def sub_tile_scan(x, dt, A, Bm, Cm, D, *, chunk, tile, p_tile=None):
    """The kernels' arithmetic for a chunk longer than their tile, in plain
    PyTorch (f32, batched over batch and head): each chunk's a_cum summed
    once over the whole chunk, as the reference sums it; the chunk run as
    sub-tiles of ``tile`` rows, each with its intra-tile product, the
    inter-tile term ``(C Sᵀ) ∘ exp(a_i − a_base)`` from the state the
    earlier sub-tiles left, and the update ``S = exp(a_end − a_base) S +
    xᵀ(exp(a_end − a_j)·dt·B)``; ``a_base`` is the sum at the end of the
    previous sub-tile, 0 at the chunk's start; ``a_cum`` summed as the
    kernels sum it (``chunk_a_cum``).  With ``p_tile``, as the kernels' P
    tiles: each run of ``p_tile`` of x's columns (the state's rows) scanned
    on its own, C Bᵀ recomputed for each, and the results joined."""
    if p_tile is not None and x.shape[3] > p_tile:
        parts = [sub_tile_scan(x[..., p0:p0 + p_tile], dt, A, Bm, Cm, D, chunk=chunk, tile=tile)
                 for p0 in range(0, x.shape[3], p_tile)]
        return torch.cat([y for y, _ in parts], dim=3), torch.cat([st for _, st in parts], dim=2)
    Bb, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    xf, dtf = x.float(), dt.float()
    Bh = Bm.float().repeat_interleave(H // G, dim=2)
    Ch = Cm.float().repeat_interleave(H // G, dim=2)
    ii = torch.arange(tile)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]
    state = torch.zeros((Bb, H, P, N))
    ys = []
    for c0 in range(0, S, chunk):
        a_chunk = SSD.chunk_a_cum(dtf[:, c0 : c0 + chunk], A, chunk)  # (B, chunk, H)
        a_base = torch.zeros((Bb, H))
        for t0 in range(0, chunk, tile):
            sl = slice(c0 + t0, c0 + t0 + tile)
            xc, dtc, Bc, Cc = xf[:, sl], dtf[:, sl], Bh[:, sl], Ch[:, sl]
            a = a_chunk[:, t0 : t0 + tile]
            a_end = a[:, -1]
            L = torch.where(causal, torch.exp(a[:, :, None] - a[:, None]), 0.0)
            cb = torch.einsum("bihn,bjhn->bijh", Cc, Bc)
            y = torch.einsum("bijh,bjhp->bihp", cb * L * dtc[:, None], xc)
            inter = torch.exp(a - a_base[:, None])[..., None]
            y = y + torch.einsum("bihn,bhpn->bihp", Cc, state) * inter
            w = torch.exp(a_end[:, None] - a) * dtc
            state = state * torch.exp(a_end - a_base)[..., None, None] + torch.einsum(
                "bjhp,bjhn->bhpn", xc, Bc * w[..., None])
            a_base = a_end
            ys.append(y + xc * D[None, None, :, None])
    return torch.cat(ys, dim=1).to(x.dtype), state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk,tile", [(256, 128), (200, 100)])
def test_sub_tiles_with_carried_state_match_the_whole_chunk(chunk, tile, dtype):
    """What the kernels compute, emulated: the chunk as sub-tiles of
    ``ssd_tile(chunk)`` rows with the chunk's a_cum and the state carried
    between them, against the Pallas kernel and the reference's chunked path
    at the whole chunk."""
    assert SSD.ssd_tile(chunk) == tile
    jargs, targs = _pair(ssd_inputs(1, B, 2 * chunk, H, P, G, N), dtype)
    y, st = sub_tile_scan(*targs, chunk=chunk, tile=tile)
    tol = SSD_TOL[dtype]
    for name, (want_y, want_st) in (
        ("pallas", rops.ssd_scan(*jargs, chunk=chunk, interpret=True)),
        ("reference ssd_chunked", RS.ssd_chunked(*jargs, chunk=chunk)),
    ):
        _close(y, want_y, tol, f"y against {name}")
        _close(st, want_st, tol, f"state against {name}")


def test_sub_tiles_match_the_plain_version_at_jamba_width():
    """What the card compares, at jamba's P 64 and N 128 in f32: the
    kernels' sub-tile arithmetic against the plain version at chunk 256.
    Both take the chunk's ``a_cum`` from ``chunk_a_cum``, so only the order
    of the products differs."""
    _, targs = _pair(ssd_inputs(2, 1, 512, 4, 64, 1, 128), "float32")
    y, st = sub_tile_scan(*targs, chunk=256, tile=128)
    want_y, want_st = SSD.ssd_scan_plain(*targs, chunk=256)
    _close(y, want_y.numpy(), SSD_TOL["float32"], "y")
    _close(st, want_st.numpy(), SSD_TOL["float32"], "state")


@pytest.mark.parametrize(
    "chunk,tile",
    [(256, 128), (128, 128), (100, 100), (200, 100), (8, 8), (1, 1), (384, 128), (131, 1),
     (262, 2)],
)
def test_ssd_tile_rule(chunk, tile):
    """The largest divisor of the chunk that is at most 128; a prime above
    128 gives 1."""
    assert SSD.ssd_tile(chunk) == tile
    assert chunk % tile == 0 and tile <= SSD.TILE_MAX


# ---------------------------------------------------------------------------
# Head and state widths past the zoo's (P 64, N 128): the Pallas kernel takes
# any; the port's kernels take any P (tiles of 64 over the grid) and N up to
# 256 (tiles of 64 rows past N 128)
# ---------------------------------------------------------------------------
WIDE = [(80, 136), (80, 256), (128, 136), (128, 256)]  # (P, N)
WIDE_IDS = [f"P{p}-N{n}" for p, n in WIDE]
WIDE_CHUNK, WIDE_S = 128, 384  # three chunks


def exact_scan(x, dt, A, Bm, Cm, D):
    """The SSD recurrence step by step in float64 (numpy inputs): ``S_t =
    exp(dt_t A) S_{t-1} + dt_t x_t B_tᵀ``, ``y_t = S_t C_t + D x_t``.  The
    yardstick of the f32 comparisons at N 256, where unit-normal B and C make
    |y| reach about 270 and two f32 summation orders part by more than 2e-4
    where y cancels (the plain version against the Pallas kernel: up to 1.27
    times the allowance, each within 0.70 of it against this)."""
    x, dt, A, Bm, Cm, D = (torch.from_numpy(np.asarray(a)).double() for a in (x, dt, A, Bm, Cm, D))
    Bb, S, H, P = x.shape
    rep = H // Bm.shape[2]
    Bh, Ch = Bm.repeat_interleave(rep, dim=2), Cm.repeat_interleave(rep, dim=2)
    state = torch.zeros((Bb, H, P, Bm.shape[3]), dtype=torch.float64)
    ys = []
    for t in range(S):
        state = state * torch.exp(dt[:, t] * A)[..., None, None] + (
            (dt[:, t, :, None] * x[:, t])[..., None] * Bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]) + D[:, None] * x[:, t])
    return torch.stack(ys, dim=1).numpy(), state.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P,N", WIDE, ids=WIDE_IDS)
def test_plain_matches_pallas_at_wide_heads_and_states(P, N, dtype):
    """The plain version at P 80 and 128, N 136 and 256, against the Pallas
    kernel in interpret mode: the function the kernels are held to on the
    card, at the widths they now take.  bf16 at 2e-2 directly; f32 at 2e-4
    with both held against the exact recurrence (``exact_scan``)."""
    arrays = ssd_inputs(7, 1, WIDE_S, 2, P, 1, N)
    jargs, targs = _pair(arrays, dtype)
    y, st = SSD.ssd_scan_plain(*targs, chunk=WIDE_CHUNK)
    assert tuple(y.shape) == (1, WIDE_S, 2, P) and tuple(st.shape) == (1, 2, P, N)
    want_y, want_st = rops.ssd_scan(*jargs, chunk=WIDE_CHUNK, interpret=True)
    if dtype == "float32":
        exact_y, exact_st = exact_scan(*arrays)
        for name, (gy, gst) in (("plain", (y, st)), ("pallas", (want_y, want_st))):
            _close(gy, exact_y, SSD_TOL[dtype], f"{name} y")
            _close(gst, exact_st, SSD_TOL[dtype], f"{name} state")
        return
    _close(y, want_y, SSD_TOL[dtype], "y")
    _close(st, want_st, SSD_TOL[dtype], "state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P,N", WIDE, ids=WIDE_IDS)
def test_p_tiles_and_wide_sub_tiles_match_pallas(P, N, dtype):
    """What the kernels compute at these widths, emulated: the state's rows
    in tiles of ``P_TILE`` (each recomputing C Bᵀ), each chunk of 128 rows
    as sub-tiles of ``ssd_tile(128, N)`` = 64 rows at N > 128, against the
    Pallas kernel at the whole chunk (bf16, 2e-2) and, in f32, against the
    exact recurrence the Pallas kernel is held to above (2e-4)."""
    tile = SSD.ssd_tile(WIDE_CHUNK, N)
    assert tile == 64 and SSD.P_TILE == 64
    arrays = ssd_inputs(8, 1, WIDE_S, 2, P, 1, N)
    jargs, targs = _pair(arrays, dtype)
    y, st = sub_tile_scan(*targs, chunk=WIDE_CHUNK, tile=tile, p_tile=SSD.P_TILE)
    if dtype == "float32":
        want_y, want_st = exact_scan(*arrays)
    else:
        want_y, want_st = rops.ssd_scan(*jargs, chunk=WIDE_CHUNK, interpret=True)
    _close(y, want_y, SSD_TOL[dtype], "y")
    _close(st, want_st, SSD_TOL[dtype], "state")


@pytest.mark.parametrize(
    "chunk,N,tile",
    [(128, 256, 64), (256, 136, 64), (100, 256, 50), (64, 256, 64), (256, 128, 128), (8, 256, 8)],
)
def test_ssd_tile_rule_depends_on_the_state_width(chunk, N, tile):
    """Past N 128 a tile holds at most 64 rows (B and C of 128 rows at N 256
    would not fit the CUDA-core kernel's shared memory); up to 128 the rule
    is the zoo's."""
    assert SSD.ssd_tile(chunk, N) == tile
    assert chunk % tile == 0 and tile <= (SSD.TILE_MAX if N <= SSD.N_TC_MAX else SSD.WIDE_TILE_MAX)


def test_plain_version_in_float64_is_the_exact_recurrence():
    """``ssd_scan_plain(..., precision=torch.float64)``, the yardstick of the
    f32 kernels past N 128 on the card, against the step-by-step recurrence
    in float64, far inside the f32 tolerance."""
    arrays = ssd_inputs(10, 1, WIDE_S, 2, 128, 1, 256)
    _, targs = _pair(arrays, "float32")
    y, st = SSD.ssd_scan_plain(*targs, chunk=WIDE_CHUNK, precision=torch.float64)
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    want_y, want_st = exact_scan(*arrays)
    _close(y, want_y, 1e-5, "y")
    _close(st, want_st, 1e-5, "state")


def test_variant_sends_wide_bf16_states_to_the_cuda_core_kernel():
    """A rule on the shape: aligned bf16 goes to the tensor cores at N ≤ 128
    whatever P, and to the CUDA-core kernel at 128 < N ≤ 256."""
    strides, ptrs = [8 * 64] * 9, [0] * 3
    assert SSD.variant(torch.bfloat16, 128, 128, strides, ptrs) == SSD.TENSOR_CORE
    assert SSD.variant(torch.bfloat16, 80, 64, strides, ptrs) == SSD.TENSOR_CORE
    assert SSD.variant(torch.bfloat16, 128, 136, strides, ptrs) == SSD.CUDA_CORE
    assert SSD.variant(torch.bfloat16, 64, 256, strides, ptrs) == SSD.CUDA_CORE
    assert SSD.variant(torch.float32, 128, 128, strides, ptrs) == SSD.CUDA_CORE


def _jamba_ratio_cfgs(use_kernels):
    """jamba-1.5-large's SSM ratios (expand 2, P = N / 2, one group) at smoke
    width, with its chunk of 256: d 64, d_inner 128, 4 heads of P 32, N 64."""
    kw = dict(dtype="float32", ssm_chunk=256, ssm_head_dim=32, ssm_state=64)
    r = dataclasses.replace(rconfigs.reduce_for_smoke(rconfigs.get("jamba-1.5-large-398b")),
                            use_pallas=use_kernels, **kw)
    t = dataclasses.replace(tconfigs.reduce_for_smoke(tconfigs.get("jamba-1.5-large-398b")),
                            use_kernels=use_kernels, **kw)
    return r, t


def _block_params(cfg, seed=5):
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in RS.ssm_param_shapes(cfg).items():
        a = rng.standard_normal(shape)
        if name in ("in_proj", "out_proj"):
            a = a * shape[0] ** -0.5
        elif name == "conv_w":
            a = a * 0.5
        elif name in ("gate_norm", "D"):
            a = 1.0 + 0.1 * a
        else:  # conv_b, A_log, dt_bias
            a = 0.3 * a
        out[name] = a.astype(np.float32)
    return out


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel-path", "chunked-path"])
def test_ssm_block_chunk256_matches_reference(use_kernels):
    """One SSM block at S 512, chunk 256: the kernel path (its plain version
    on the CPU) against the reference's Pallas path, the chunked path against
    the chunked path."""
    rcfg, tcfg = _jamba_ratio_cfgs(use_kernels)
    assert tcfg.ssm_chunk == 256 and tcfg.ssm_groups == 1
    params = _block_params(rcfg)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    pt = {k: torch.from_numpy(v) for k, v in params.items()}
    x = np.random.default_rng(6).standard_normal((1, 512, rcfg.d_model)).astype(np.float32)
    y_r, (st_r, tail_r) = RS.ssm_block(pj, jnp.asarray(x), rcfg)
    with torch.no_grad():
        y_t, (st_t, tail_t) = TS.ssm_block(pt, torch.from_numpy(x), tcfg)
    _close(y_t, y_r, BLOCK_TOL, "y")
    _close(st_t, st_r, BLOCK_TOL, "state")
    _close(tail_t, tail_r, BLOCK_TOL, "conv tail")


# ---------------------------------------------------------------------------
# On a card: the kernels at chunk 256
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_kernels_at_chunk256_match_plain(cuda, dtype):
    """Each variant at chunk 256 (jamba's P 64, N 128) against the plain
    version at chunk 256; one launch a call."""
    _, args = _pair(ssd_inputs(2, 2, 512, 4, 64, 1, 128), dtype, cuda)
    kern = SSD.ssd_scan_tc if dtype == "bfloat16" else SSD.ssd_scan_cuda_core
    before, before_v = SSD.ssd_scan.launches, kern.launches
    y, st = SSD.ssd_scan(*args, chunk=256)
    torch.cuda.synchronize()
    assert (SSD.ssd_scan.launches, kern.launches) == (before + 1, before_v + 1)
    want_y, want_st = SSD.ssd_scan_plain(*args, chunk=256)
    _close(y, want_y.float().cpu().numpy(), SSD_TOL[dtype], "y")
    _close(st, want_st.cpu().numpy(), SSD_TOL[dtype], "state")


def test_cuda_ssd_kernels_still_refuse_wide_heads_and_states(cuda):
    """The domain's limit: N past 256 raises, naming the limit, whatever P;
    the tensor-core kernel refuses N past 128 (the rule sends such bf16 to
    the CUDA-core kernel); a chunk that does not divide S raises.  P has no
    limit of its own: P 65 runs."""
    _, (x, dt, A, Bm, Cm, D) = _pair(ssd_inputs(3, 1, 256, 2, 65, 1, 257), "float32", cuda)
    with pytest.raises(ValueError, match="N <= 256 .*got N=257"):
        SSD.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256)
    with pytest.raises(ValueError, match="N <= 256 .*got N=257"):
        SSD.ssd_scan_cuda_core(x[..., :64], dt, A, Bm, Cm, D, chunk=256)
    with pytest.raises(ValueError, match="N <= 128"):
        _, bf = _pair(ssd_inputs(3, 1, 256, 2, 64, 1, 136), "bfloat16", cuda)
        SSD.ssd_scan_tc(*bf, chunk=256)
    with pytest.raises(ValueError, match="multiple of chunk"):
        SSD.ssd_scan(x[..., :64], dt, A, Bm[..., :128], Cm[..., :128], D, chunk=96)
    y, st = SSD.ssd_scan(x, dt, A, Bm[..., :128], Cm[..., :128], D, chunk=256)
    want_y, want_st = SSD.ssd_scan_plain(x, dt, A, Bm[..., :128], Cm[..., :128], D, chunk=256)
    _close(y, want_y.cpu().numpy(), SSD_TOL["float32"], "y at P 65")
    _close(st, want_st.cpu().numpy(), SSD_TOL["float32"], "state at P 65")
