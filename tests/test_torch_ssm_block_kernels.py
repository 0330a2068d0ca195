"""The Mamba-2 block's fused kernels on each side of the SSD scan
(``kernels/ssm_block.py``, ``csrc/ssm_block.cu``): the causal conv with its
bias and SiLU, and the gate with its RMSNorm.

On the CPU, ``kernels.ops`` takes the plain versions, which must give the
block's own sequence of eager ops bit for bit (the sequence ``ssm_block``
ran before the kernels, written out below as the yardstick), in bf16 and
f32, at lengths shorter than the conv's window and longer, with xBC read
from a wider f32 row and in a tensor-parallel rank's channel layout.  On a
CUDA card only, each kernel against its plain version at mamba2-130m's and
jamba's widths, within one unit in the last place of the model dtype.

    PYTHONPATH=src python -m pytest -q tests/test_torch_ssm_block_kernels.py
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd as SSD  # noqa: E402
from repro_torch.kernels import ssm_block as SB  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.layers import _dot_f32  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The gated norm's allowance on the card, in units in the last place: the
# kernel sums the row's squares in another order than PyTorch's reduction,
# which moves the f32 rsqrt and so the f32 output by a few units (4 at most
# at d 16,384 on an H100); rounded to bf16 that is one unit at most.
NORM_ULPS = {"bfloat16": 1, "float32": 8}
LENGTHS = [1, 2, 3, 257, 2048]  # 1-3: shorter than the conv's window less one


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


def smoke_cfg(dtype: str = "bfloat16"):
    return dataclasses.replace(configs.reduce_for_smoke(configs.get("mamba2-130m")), dtype=dtype)


def block_params(cfg, seed: int, device="cpu") -> dict:
    """One SSM block's parameters, f32 leaves where the model keeps them f32
    (A_log, D, dt_bias) and the model dtype elsewhere."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in TS.ssm_param_shapes(cfg).items():
        a = torch.randn(shape, generator=g)
        if name in ("in_proj", "out_proj"):
            a = a * shape[0] ** -0.5
        elif name == "conv_w":
            a = a * 0.5
        elif name in ("gate_norm", "D"):
            a = 1.0 + 0.1 * a
        else:  # conv_b, A_log, dt_bias
            a = 0.3 * a
        f32 = name in ("A_log", "D", "dt_bias")
        out[name] = a.to(device=device, dtype=torch.float32 if f32 else cfg.torch_dtype)
    return out


def rank_ctx(rank: int, m: int = 2):
    """The two things ``_rank_leaves`` reads of a mesh context: the model
    axis's size and this rank's part of it."""
    return types.SimpleNamespace(model_size=m, part=lambda n: (rank * n // m, (rank + 1) * n // m))


def projection(cfg, seed: int, B: int, S: int, layout: str, device="cpu"):
    """(zxbcdt (B, S, W) f32 as ``_dot_f32`` leaves it, the leaves, d_inner
    of the layout): every head's (``whole``) or the second of two ranks'
    (``split``, ``_rank_leaves``: the rank's z and x columns, all of B and
    C, its dt)."""
    params = block_params(cfg, seed, device)
    heads = None
    if layout == "split":
        params, _, di, heads = TS._rank_leaves(params, cfg, rank_ctx(1))
        assert heads is not None and di == cfg.d_inner // 2
    else:
        di = cfg.d_inner
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator().manual_seed(seed + 1))
    x = x.to(device=device, dtype=cfg.torch_dtype)
    return _dot_f32(x, params["in_proj"]), params, di


def block_sequence_conv(cfg, zxbcdt, params, di):
    """The conv as ``ssm_block`` ran it before the kernels."""
    dt0 = cfg.torch_dtype
    H = zxbcdt.shape[-1] - 2 * di - 2 * cfg.ssm_groups * cfg.ssm_state
    _, xr, Bm, Cm, _ = TS._split_proj(cfg, zxbcdt, di, H)
    xBC = torch.cat([xr, Bm, Cm], dim=-1).to(dt0)
    return TS._causal_conv(xBC, params["conv_w"].float(), params["conv_b"].float()).to(dt0)


def conv_input(cfg, zxbcdt, params, di):
    C = di + 2 * cfg.ssm_groups * cfg.ssm_state
    return zxbcdt[..., di : di + C], params["conv_w"].float(), params["conv_b"].float()


def parent_kernel_path(params, x, cfg):
    """``ssm_block``'s kernel path as it ran before the fused kernels: the
    casts, the cat, the conv, the scan, the round trip of y through f32 and
    the gated norm as separate ops (heads whole)."""
    Bb, S, _ = x.shape
    dt0 = x.dtype
    di, H, G, N, Pd = cfg.d_inner, cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    zxbcdt = _dot_f32(x, params["in_proj"])
    z, xr, Bm, Cm, dt = TS._split_proj(cfg, zxbcdt)
    z = z.to(dt0)
    xBC = torch.cat([xr, Bm, Cm], dim=-1).to(dt0)
    xBC = TS._causal_conv(xBC, params["conv_w"].float(), params["conv_b"].float()).to(dt0)
    xr, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)
    dtv = F.softplus(dt + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    xh, Bg, Cg = xr.reshape(Bb, S, H, Pd), Bm.reshape(Bb, S, G, N), Cm.reshape(Bb, S, G, N)
    chunk = min(cfg.ssm_chunk, S)
    if S % chunk:
        padn = chunk - S % chunk
        xh = F.pad(xh, (0, 0, 0, 0, 0, padn))
        dtv = F.pad(dtv, (0, 0, 0, padn))
        Bg = F.pad(Bg, (0, 0, 0, 0, 0, padn))
        Cg = F.pad(Cg, (0, 0, 0, 0, 0, padn))
    y, state = SSD.ssd_scan_plain(xh, dtv, A, Bg, Cg, params["D"].float(), chunk=chunk)
    y = y.float()[:, :S].reshape(Bb, S, di).to(dt0)
    y = TS._gated_norm(y * F.silu(z), params["gate_norm"], cfg, None, None)
    return TS._out_proj(y, params["out_proj"], None, None, dt0), state


def scan_output(cfg, seed: int, B: int, S: int, device="cpu"):
    """y (B, S, d_inner) in the model dtype as the scan hands it on: a view
    of a (B, S_padded, H, P) output cut to S."""
    pad = -S % cfg.ssm_chunk
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(B, S + pad, cfg.ssm_heads, cfg.ssm_head_dim, generator=g).to(device=device, dtype=cfg.torch_dtype)
    return y[:, :S].reshape(B, S, cfg.d_inner)


def ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest gap between got and want in units in the last place of
    their dtype: how many representable numbers apart they lie (the bit
    patterns read as integers ordered like the values; -0 and +0 are one)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[want.dtype]
    sign = torch.iinfo(bits).max

    def ordered(t):
        i = t.contiguous().view(bits).long()
        return torch.where(i < 0, -(i & sign), i)

    return int((ordered(got) - ordered(want)).abs().max())


# ---------------------------------------------------------------------------
# On the CPU: the plain versions are the block's sequence
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["whole", "split"])
@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_conv_is_the_block_sequence(dtype, S, layout):
    cfg = smoke_cfg(dtype)
    zxbcdt, params, di = projection(cfg, 1, 2, S, layout)
    xBC, w, b = conv_input(cfg, zxbcdt, params, di)
    assert xBC.stride(1) == zxbcdt.shape[-1] and not xBC.is_contiguous()
    got = ops.ssm_conv(xBC, w, b, cfg.torch_dtype)
    want = block_sequence_conv(cfg, zxbcdt, params, di)
    assert got.dtype == cfg.torch_dtype and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gate_norm_is_the_block_sequence(dtype, S):
    cfg = smoke_cfg(dtype)
    zxbcdt, params, di = projection(cfg, 2, 2, S, "whole")
    z = zxbcdt[..., :di]
    y = scan_output(cfg, 3, 2, S)
    got = ops.ssm_gate_norm(y, z, params["gate_norm"], cfg.norm_eps)
    want = TS._gated_norm(y.float().to(cfg.torch_dtype) * F.silu(z.to(cfg.torch_dtype)),
                          params["gate_norm"], cfg, None, None)
    assert got.dtype == cfg.torch_dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("S", [3, 40, 64])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssm_block_kernel_path_is_the_block_sequence(dtype, S):
    """The whole block on the kernel path, bit for bit the sequence it ran
    before, and in f32 within the model-level 2e-3 of the chunked path."""
    cfg = smoke_cfg(dtype)
    params = block_params(cfg, 4)
    x = torch.randn(2, S, cfg.d_model, generator=torch.Generator().manual_seed(5)).to(cfg.torch_dtype)
    with torch.no_grad():
        y, (state, tail) = TS.ssm_block(params, x, cfg)
        want_y, want_state = parent_kernel_path(params, x, cfg)
        assert torch.equal(y, want_y) and torch.equal(state, want_state)
        if dtype == "float32":
            y_x, (state_x, tail_x) = TS.ssm_block(params, x, dataclasses.replace(cfg, use_kernels=False))
            torch.testing.assert_close(y, y_x, atol=2e-3, rtol=2e-3)
            torch.testing.assert_close(state, state_x, atol=2e-3, rtol=2e-3)
            assert torch.equal(tail, tail_x)


@pytest.mark.parametrize("entry", ["ssm_conv", "ssm_gate_norm"])
def test_wrappers_refuse_an_input_that_requires_grad(entry):
    cfg = smoke_cfg("float32")
    zxbcdt, params, di = projection(cfg, 6, 1, 8, "whole")
    zxbcdt.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        if entry == "ssm_conv":
            ops.ssm_conv(*conv_input(cfg, zxbcdt, params, di), cfg.torch_dtype)
        else:
            ops.ssm_gate_norm(scan_output(cfg, 7, 1, 8), zxbcdt[..., :di], params["gate_norm"], cfg.norm_eps)
    with torch.no_grad():  # under no_grad the same call runs
        ops.ssm_conv(*conv_input(cfg, zxbcdt, params, di), cfg.torch_dtype)


def test_cpu_dispatch_takes_plain_versions_and_never_launches():
    cfg = smoke_cfg()
    zxbcdt, params, di = projection(cfg, 8, 2, 16, "whole")
    before = (SB.ssm_conv.launches, SB.ssm_gate_norm.launches)
    ops.ssm_conv(*conv_input(cfg, zxbcdt, params, di), cfg.torch_dtype)
    ops.ssm_gate_norm(scan_output(cfg, 9, 2, 16), zxbcdt[..., :di], params["gate_norm"], cfg.norm_eps)
    TS.ssm_block(block_params(cfg, 10), torch.zeros(1, 8, cfg.d_model, dtype=cfg.torch_dtype), cfg)
    assert (SB.ssm_conv.launches, SB.ssm_gate_norm.launches) == before == (0, 0)


def test_kernel_wrappers_refuse_cpu_tensors():
    cfg = smoke_cfg()
    zxbcdt, params, di = projection(cfg, 11, 1, 8, "whole")
    with pytest.raises(ValueError, match="not a CUDA device"):
        SB.ssm_conv(*conv_input(cfg, zxbcdt, params, di), cfg.torch_dtype)
    with pytest.raises(ValueError, match="not a CUDA device"):
        SB.ssm_gate_norm(scan_output(cfg, 12, 1, 8), zxbcdt[..., :di], params["gate_norm"], cfg.norm_eps)
    assert (SB.ssm_conv.launches, SB.ssm_gate_norm.launches) == (0, 0)


def test_dispatch_refuses_other_devices():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.ssm_conv(torch.empty(1, 8, 16, **meta), torch.empty(4, 16, **meta), torch.empty(16, **meta),
                     torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel"):
        ops.ssm_gate_norm(torch.empty(1, 8, 16, **meta), torch.empty(1, 8, 16, **meta),
                          torch.empty(16, **meta), 1e-5)


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------
GRANITE = "granite-4.0-h-small"  # not a preset: mamba2-130m's SSM at d 4096 (d_inner 8192, 128 heads)


def wide_cfg(arch: str, dtype: str):
    if arch == GRANITE:
        return dataclasses.replace(configs.get("mamba2-130m"), d_model=4096, dtype=dtype)
    return dataclasses.replace(configs.get(arch), dtype=dtype)


def card_projection(cfg, seed: int, B: int, S: int, device, layout: str = "whole", odd_row: bool = False):
    """zxbcdt drawn directly on the card at the config's widths (no in_proj:
    jamba's is 0.5 GB), its conv and norm leaves; ``odd_row`` adds one
    column to the row, so no row past the first is 16-byte aligned."""
    di, GN = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    g = torch.Generator(device=device).manual_seed(seed)
    H = cfg.ssm_heads
    if layout == "split":
        di, H = di // 2, H // 2
    W = 2 * di + 2 * GN + H + int(odd_row)
    zxbcdt = torch.randn(B, S, W, generator=g, device=device)
    C = di + 2 * GN
    w = torch.randn(cfg.ssm_conv, C, generator=g, device=device) * 0.5
    b = torch.randn(C, generator=g, device=device) * 0.3
    scale = (1.0 + 0.1 * torch.randn(di, generator=g, device=device)).to(cfg.torch_dtype)
    return zxbcdt, w, b, scale, di


CARD_CONV = [
    # arch, B, S, layout, odd_row
    ("mamba2-130m", 4, 2048, "whole", False),  # W 3352, C 1792 at offset 1536
    ("mamba2-130m", 4, 1000, "whole", False),  # S not a multiple of the run
    ("mamba2-130m", 3, 3, "whole", False),     # shorter than the window
    ("mamba2-130m", 2, 777, "split", False),   # a rank's channels: C 1024 at offset 768
    ("mamba2-130m", 2, 300, "whole", True),    # no 16-byte loads
    ("jamba-1.5-large-398b", 1, 1024, "whole", False),  # d_inner 16,384, C 16,640
    (GRANITE, 4, 4096, "whole", False),  # the granite cell's batch: d_inner 8192, C 8448 at offset 8192
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch,B,S,layout,odd_row", CARD_CONV)
def test_cuda_conv_matches_plain(cuda, arch, B, S, layout, odd_row, dtype):
    """Within one unit in the model dtype's last place: the arithmetic is
    the plain version's op for op, but SiLU's ``exp`` may round its last
    f32 bit apart from PyTorch's."""
    cfg = wide_cfg(arch, dtype)
    zxbcdt, w, b, _, di = card_projection(cfg, 21, B, S, cuda, layout, odd_row)
    xBC = zxbcdt[..., di : di + w.shape[1]]
    before = SB.ssm_conv.launches
    got = ops.ssm_conv(xBC, w, b, cfg.torch_dtype)
    torch.cuda.synchronize()
    assert SB.ssm_conv.launches == before + 1
    assert got.dtype == cfg.torch_dtype and got.is_contiguous() and tuple(got.shape) == tuple(xBC.shape)
    assert ulps(got, SB.ssm_conv_plain(xBC, w, b, cfg.torch_dtype)) <= 1


CARD_NORM = [
    # arch, B, S, odd_row
    ("mamba2-130m", 4, 2048, False),  # d 1536: a warp a row
    ("mamba2-130m", 3, 1000, False),
    ("mamba2-130m", 2, 300, True),    # no 16-byte loads of z
    ("jamba-1.5-large-398b", 1, 1024, False),  # d 16,384: a block a row
    (GRANITE, 4, 4096, False),  # d 8192: the granite cell's batch
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch,B,S,odd_row", CARD_NORM)
def test_cuda_gate_norm_matches_plain(cuda, arch, B, S, odd_row, dtype):
    """Within ``NORM_ULPS`` of the plain version: SiLU's ``exp`` may round
    its last f32 bit apart from PyTorch's, and the mean of squares sums the
    row in another order."""
    cfg = wide_cfg(arch, dtype)
    zxbcdt, _, _, scale, di = card_projection(cfg, 22, B, S, cuda, odd_row=odd_row)
    z = zxbcdt[..., :di]
    y = scan_output(cfg, 23, B, S, cuda)
    before = SB.ssm_gate_norm.launches
    got = ops.ssm_gate_norm(y, z, scale, cfg.norm_eps)
    torch.cuda.synchronize()
    assert SB.ssm_gate_norm.launches == before + 1
    assert got.dtype == cfg.torch_dtype and got.is_contiguous()
    assert ulps(got, SB.ssm_gate_norm_plain(y, z, scale, cfg.norm_eps)) <= NORM_ULPS[dtype]


def test_cuda_gate_norm_at_ragged_width(cuda):
    """d not a multiple of 8 (element loads), a warp a row and a block a row."""
    for d in (100, 2050):
        g = torch.Generator(device=cuda).manual_seed(d)
        y = torch.randn(2, 33, d, generator=g, device=cuda).to(torch.bfloat16)
        z = torch.randn(2, 33, d + 3, generator=g, device=cuda)[..., 3:]
        scale = torch.rand(d, generator=g, device=cuda) + 0.5
        got = ops.ssm_gate_norm(y, z, scale, 1e-5)
        assert ulps(got, SB.ssm_gate_norm_plain(y, z, scale, 1e-5)) <= 1


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_ssm_block_with_and_without_kernels(cuda, dtype):
    """mamba2-130m's block at full width on the card: one launch of each of
    the three kernels a call, the kernel path within the model-level 2e-3
    of the chunked path in f32; in bf16 the two paths round y at other
    places (the chunked path per chunk), so y is held at 2e-2 of its
    largest magnitude, as chip_smoke.py holds jamba's block."""
    cfg = wide_cfg("mamba2-130m", dtype)
    params = block_params(cfg, 24, cuda)
    x = torch.randn(2, 1000, cfg.d_model, generator=torch.Generator(device=cuda).manual_seed(25),
                    device=cuda).to(cfg.torch_dtype)
    counters = (SB.ssm_conv, SB.ssm_gate_norm, SSD.ssd_scan)
    with torch.no_grad():
        before = [f.launches for f in counters]
        y, (state, tail) = TS.ssm_block(params, x, cfg)
        torch.cuda.synchronize()
        assert [f.launches for f in counters] == [n + 1 for n in before]
        y_x, (state_x, tail_x) = TS.ssm_block(params, x, dataclasses.replace(cfg, use_kernels=False))
    assert torch.equal(tail, tail_x)
    tol = 2e-3 if dtype == "float32" else 2e-2
    atol = tol if dtype == "float32" else tol * y_x.float().abs().max().item()
    torch.testing.assert_close(y.float(), y_x.float(), atol=atol, rtol=tol)
    torch.testing.assert_close(state, state_x, atol=tol, rtol=tol)
