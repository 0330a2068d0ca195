"""Mamba-2 (SSD — state-space duality) token mixer.  The PyTorch port of
``repro.models.ssm``.

Three computations of the same selective-SSM recurrence

    S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * B_t x_t^T          (state: H, P, N)
    y_t = C_t . S_t + D_h * x_t

  * ``ssd_reference``   — sequential scan over time, the oracle;
  * ``ssd_chunked``     — the chunked algorithm: quadratic within length-Q
    chunks plus a linear state recurrence across them (the prefill path
    when ``cfg.use_kernels`` is off);
  * ``ssd_decode_step`` — the one-token update of the serving engine.

With ``cfg.use_kernels`` the prefill goes through ``kernels.ops.ssd_scan``
(the hand-written CUDA kernel on the card, its plain version on the CPU).
Shapes follow the reference: x (B,S,H,P), dt (B,S,H), A (H,) one scalar per
head, B/C (B,S,G,N) with heads grouped G | H.  Products accumulate in f32,
as the reference's ``preferred_element_type=jnp.float32`` einsums do.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _dot_f32, checkpointed, rms_norm
from repro_torch.models.parallel import (
    MeshContext,
    gather_over_model,
    into_region,
    model_size,
    out_of_region,
    ssm_split,
    sum_over_model,
)


def _heads(t: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """Group axis -> head axis (``jnp.repeat``): head h reads group h // rep."""
    return t.repeat_interleave(rep, dim=dim) if rep > 1 else t


def _sequential_scan(x, dt, A, Bm, Cm) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence step by step: (C_t . S_t over t (B,S,H,P), final S)."""
    Bb, S, H, Pd = x.shape
    rep = H // Bm.shape[2]
    Bh, Ch = _heads(Bm, rep, 2), _heads(Cm, rep, 2)  # (B,S,H,N)
    state = torch.zeros((Bb, H, Pd, Bm.shape[-1]), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A)  # (B,H)
        state = state * decay[..., None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dt[:, t], Bh[:, t], x[:, t]
        )
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    return torch.stack(ys, dim=1), state


def ssd_reference(x, dt, A, Bm, Cm, D) -> torch.Tensor:
    """Sequential scan over time — the oracle.  All args f32.

    x: (B,S,H,P) dt: (B,S,H) A: (H,) Bm/Cm: (B,S,G,N) D: (H,)
    """
    y, _ = _sequential_scan(x, dt, A, Bm, Cm)
    return y + x * D[None, None, :, None]


def ssd_chunked(x, dt, A, Bm, Cm, D, *, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: returns (y (B,S,H,P) f32, final_state (B,H,P,N) f32).

    Within a chunk the work is a masked 'attention' product
    (C_i . B_j) * exp(a_i - a_j) * dt_j; across chunks the (H,P,N) state is
    carried by a loop of length S/Q.  As in the reference, y is rounded to
    x's dtype per chunk and ``x·D`` is added in f32 afterwards.
    """
    Bb, S, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    assert S % chunk == 0, (S, chunk)
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]  # (1,Qi,Qj,1)

    S_prev = torch.zeros((Bb, H, Pd, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        # checkpointed while autograd records, as the reference's scan body
        S_prev, y = checkpointed(
            _ssd_chunk, S_prev, x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl], A, causal, rep
        )
        ys.append(y)
    y = torch.cat(ys, dim=1)
    return y + x * D[None, None, :, None], S_prev


def _ssd_chunk(S_prev, x_j, dt_j, B_j, C_j, A, causal, rep: int):
    """One chunk of ``ssd_chunked``: (state leaving it, y in x's dtype)."""
    a = dt_j * A[None, None, :]  # (B,Q,H)
    a_cum = torch.cumsum(a, dim=1)
    a_total = a_cum[:, -1, :]  # (B,H)
    # intra-chunk: L[i,j] = exp(a_i - a_j) (i>=j), selected, never inf*0
    seg = a_cum[:, :, None, :] - a_cum[:, None, :, :]  # (B,Qi,Qj,H)
    L = torch.where(causal, torch.exp(seg), 0.0)
    cb = torch.einsum("bign,bjgn->bijg", C_j.float(), B_j.float())  # (B,Qi,Qj,G)
    cb = _heads(cb, rep, -1)
    M = cb * L * dt_j[:, None, :, :].float()
    y = torch.einsum("bijh,bjhp->bihp", M, x_j.float())
    # inter-chunk: y_i += exp(a_cum[i]) C_i . S_entering
    Ch = _heads(C_j, rep, 2).float()  # (B,Q,H,N)
    y = y + torch.einsum("bqhn,bhpn->bqhp", Ch, S_prev) * torch.exp(a_cum)[..., None]
    # state update: S_new = exp(a_total) S_prev + sum_j exp(a_total-a_j) dt_j B_j x_j
    w = torch.exp(a_total[:, None, :] - a_cum) * dt_j.float()  # (B,Q,H)
    Bh = _heads(B_j, rep, 2).float()
    cs = torch.einsum("bqh,bqhn,bqhp->bhpn", w, Bh, x_j.float())
    S_new = S_prev * torch.exp(a_total)[..., None, None] + cs
    return S_new, y.to(x_j.dtype)  # stream y in the model dtype


def ssd_decode_step(state, x, dt, A, Bm, Cm, D):
    """One-token recurrence. state (B,H,P,N); x (B,H,P); dt (B,H);
    Bm/Cm (B,G,N).  Returns (y (B,H,P), new_state)."""
    rep = x.shape[1] // Bm.shape[1]
    Bh, Ch = _heads(Bm, rep, 1), _heads(Cm, rep, 1)  # (B,H,N)
    decay = torch.exp(dt * A)  # (B,H)
    state = state * decay[..., None, None] + torch.einsum("bh,bhn,bhp->bhpn", dt, Bh, x)
    y = torch.einsum("bhpn,bhn->bhp", state, Ch) + x * D[None, :, None]
    return y, state


# ---------------------------------------------------------------------------
# The full Mamba-2 block (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------
def ssm_param_shapes(cfg: ArchConfig) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * G * N
    return {
        "in_proj": (d, 2 * di + 2 * G * N + H),
        "conv_w": (cfg.ssm_conv, conv_dim),
        "conv_b": (conv_dim,),
        "A_log": (H,),
        "D": (H,),
        "dt_bias": (H,),
        "gate_norm": (di,),
        "out_proj": (di, d),
    }


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor, di: int = None, H: int = None):
    """z, x, B, C, dt along the last axis (views, no copy); ``di`` and ``H``
    are this rank's where the heads are split over model."""
    di = cfg.d_inner if di is None else di
    H = cfg.ssm_heads if H is None else H
    GN = cfg.ssm_groups * cfg.ssm_state
    return torch.split(zxbcdt, [di, di, GN, GN, H], dim=-1)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, then SiLU.  xBC (B,S,C) in the model dtype,
    w (K,C) and b (C,) in f32: each product is taken in f32, as in the
    reference, and the taps are summed left to right."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i : i + S, :] * w[i][None, None, :] for i in range(K))
    return F.silu(out + b)


def _rank_leaves(params, cfg: ArchConfig, ctx: Optional[MeshContext]):
    """(leaves, H, d_inner, heads) as this rank's SSM reads them.  Under a
    ``ctx`` whose model axis splits the heads (``ssm_split``): ``in_proj``'s
    z, x and dt columns of the rank's heads and all of B and C (G = 1:
    every head reads them), ``conv_w``/``conv_b`` on the rank's x channels
    and B, C, ``A_log``/``D``/``dt_bias``/``gate_norm`` on its heads (each
    gathered whole, so its gradient sums over model), ``out_proj`` its rows
    (kept shard).  Otherwise the leaves as they are and ``heads`` None."""
    H, Pd = cfg.ssm_heads, cfg.ssm_head_dim
    if not ssm_split(cfg, model_size(ctx)):
        return params, H, cfg.d_inner, None
    h0, h1 = ctx.part(H)
    di, GN = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    x0, x1 = h0 * Pd, h1 * Pd
    w = params["in_proj"]
    cols = (w[:, x0:x1], w[:, di + x0 : di + x1], w[:, 2 * di : 2 * di + 2 * GN],
            w[:, 2 * di + 2 * GN + h0 : 2 * di + 2 * GN + h1])

    def channels(t):  # conv channels x | B | C: the rank's x, all of B and C
        return torch.cat([t[..., x0:x1], t[..., di:]], dim=-1)

    leaves = dict(in_proj=torch.cat(cols, dim=1), conv_w=channels(params["conv_w"]),
                  conv_b=channels(params["conv_b"]), A_log=params["A_log"][h0:h1],
                  D=params["D"][h0:h1], dt_bias=params["dt_bias"][h0:h1],
                  gate_norm=params["gate_norm"][x0:x1], out_proj=params["out_proj"])
    return leaves, h1 - h0, x1 - x0, (h0, h1)


def _gated_norm(v: torch.Tensor, scale: torch.Tensor, cfg: ArchConfig, ctx, heads) -> torch.Tensor:
    """The gated RMSNorm over all of d_inner: where the heads are split,
    each rank's sum of squares of its channels is summed over model
    (forward and backward, ``sum_over_model``)."""
    if heads is None:
        return rms_norm(v, scale, cfg.norm_eps)
    dt = v.dtype
    v = v.float()
    ss = sum_over_model((v * v).sum(dim=-1, keepdim=True), ctx)
    v = v * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps)
    return (v * scale.float()).to(dt)


def _out_proj(y: torch.Tensor, w: torch.Tensor, ctx, heads, dt) -> torch.Tensor:
    """The row-parallel ``out_proj``: f32 partial sums all-reduced, then cast."""
    out = _dot_f32(y, w)
    if heads is not None:
        out = out_of_region(out, ctx)
    return out.to(dt)


def ssm_block(params, x: torch.Tensor, cfg: ArchConfig, ctx: Optional[MeshContext] = None) -> Tuple[torch.Tensor, tuple]:
    """Mamba-2 mixer over a full sequence (prefill).

    Returns (y (B,S,d), carry) where carry = (ssd_state, conv_tail) for
    handing off to incremental decode.  Under a ``ctx`` that splits the
    heads (``_rank_leaves``) the scan runs on this rank's H/m heads and the
    carry holds their state and the conv tail of the rank's channels (x of
    its heads, then B and C).
    """
    Bb, S, d = x.shape
    dt0 = x.dtype
    params, H, di, heads = _rank_leaves(params, cfg, ctx)
    G, N, Pd = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    if heads is not None:
        x = into_region(x, ctx)
    zxbcdt = _dot_f32(x, params["in_proj"])  # f32
    z, xr, Bm, Cm, dt = _split_proj(cfg, zxbcdt, di, H)
    # Activation streams (z, x, B, C) live in the model dtype; only the dt
    # path, the decay chain and the SSD state stay f32.
    z = z.to(dt0)
    xBC = torch.cat([xr, Bm, Cm], dim=-1).to(dt0)
    xBC = _causal_conv(xBC, params["conv_w"].float(), params["conv_b"].float())
    xBC = xBC.to(dt0)
    # x, B and C stay views of xBC: the kernel reads them through their strides
    xr, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)
    # F.softplus (the identity above 20, where log1p(exp(x)) and x agree in
    # f32) and jax.nn.softplus (logaddexp(x, 0)) agree to f32 rounding
    dtv = F.softplus(dt + params["dt_bias"].float())  # (B,S,H)
    A = -torch.exp(params["A_log"].float())
    xh = xr.reshape(Bb, S, H, Pd)
    Bg = Bm.reshape(Bb, S, G, N)
    Cg = Cm.reshape(Bb, S, G, N)
    chunk = min(cfg.ssm_chunk, S)
    if S % chunk:  # pad to a chunk multiple (prefill of odd lengths)
        padn = chunk - S % chunk
        xh = F.pad(xh, (0, 0, 0, 0, 0, padn))
        dtv = F.pad(dtv, (0, 0, 0, padn))
        Bg = F.pad(Bg, (0, 0, 0, 0, 0, padn))
        Cg = F.pad(Cg, (0, 0, 0, 0, 0, padn))
    D = params["D"].float()
    if cfg.use_kernels:
        from repro_torch.kernels.ops import ssd_scan  # lazy: no cycle

        # y + D·x comes back rounded once to the model dtype
        y, ssd_state = ssd_scan(xh, dtv, A, Bg, Cg, D, chunk=chunk)
        y = y.float()
    else:
        y, ssd_state = ssd_chunked(xh, dtv, A, Bg, Cg, D, chunk=chunk)
    y = y[:, :S].reshape(Bb, S, di).to(dt0)
    y = _gated_norm(y * F.silu(z), params["gate_norm"], cfg, ctx, heads)
    out = _out_proj(y, params["out_proj"], ctx, heads, dt0)
    # conv tail: last (K-1) *pre-conv* channel values, for incremental decode
    K = cfg.ssm_conv
    _, xr_t, Bm_t, Cm_t, _ = _split_proj(cfg, zxbcdt[:, -(K - 1) :, :], di, H)
    conv_tail = torch.cat([xr_t, Bm_t, Cm_t], dim=-1)  # (B,K-1,conv_dim) f32
    return out, (ssd_state, conv_tail)


def ssm_block_decode(
    params, x: torch.Tensor, cfg: ArchConfig, carry, ctx: Optional[MeshContext] = None
) -> Tuple[torch.Tensor, tuple]:
    """One-token Mamba-2 step.  x (B,1,d); carry (ssd_state, conv_tail).
    Returns (y (B,1,d), (new_state, new_tail)), both new tensors.

    Under a ``ctx`` that splits the heads the step runs on this rank's
    heads.  ``ssd_state`` holds the rank's heads (updated as they are) or
    every head (the rank's read; the new state of every head gathered over
    the model group).  ``conv_tail`` holds every channel: the rank convolves
    its own, and the new token's x channels of every head are gathered over
    the model group so the new tail holds every channel too."""
    Bb, S, d = x.shape
    assert S == 1
    dt0 = x.dtype
    params, H, di, heads = _rank_leaves(params, cfg, ctx)
    G, N, Pd = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    ssd_state, conv_tail = carry
    zxbcdt = _dot_f32(x, params["in_proj"])
    z, xr, Bm, Cm, dt = _split_proj(cfg, zxbcdt, di, H)
    if heads is None:
        window = torch.cat([conv_tail, torch.cat([xr, Bm, Cm], dim=-1)], dim=1)  # (B,K,conv_dim) f32
        mine = window
    else:
        xr_all = gather_over_model(xr, ctx, 2)
        window = torch.cat([conv_tail, torch.cat([xr_all, Bm, Cm], dim=-1)], dim=1)
        x0 = heads[0] * Pd
        mine = torch.cat([window[..., x0 : x0 + di], window[..., cfg.d_inner :]], dim=-1)
    w = params["conv_w"].float()
    out = (mine * w[None, :, :]).sum(dim=1, keepdim=True)
    xBC = F.silu(out + params["conv_b"].float())
    xr2, Bm2, Cm2 = torch.split(xBC[:, 0], [di, G * N, G * N], dim=-1)
    dtv = F.softplus(dt[:, 0] + params["dt_bias"].float())  # (B,H)
    A = -torch.exp(params["A_log"].float())
    every = heads is not None and ssd_state.shape[1] == cfg.ssm_heads
    state = ssd_state[:, heads[0] : heads[1]] if every else ssd_state
    y, state = ssd_decode_step(
        state,
        xr2.reshape(Bb, H, Pd),
        dtv,
        A,
        Bm2.reshape(Bb, G, N),
        Cm2.reshape(Bb, G, N),
        params["D"].float(),
    )
    if every:
        state = gather_over_model(state, ctx, 1)
    y = y.reshape(Bb, 1, di)
    y = _gated_norm((y * F.silu(z)).to(dt0), params["gate_norm"], cfg, ctx, heads)
    out = _out_proj(y, params["out_proj"], ctx, heads, dt0)
    return out, (state, window[:, 1:, :])


def ssm_empty_carry(cfg: ArchConfig, batch: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero (ssd_state (B,H,P,N), conv_tail (B,K-1,conv_dim)), both f32."""
    di, G, N, H, Pd = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    conv_dim = di + 2 * G * N
    return (
        torch.zeros((batch, H, Pd, N), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=torch.float32, device=device),
    )
