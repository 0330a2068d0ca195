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

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _dot_f32, checkpointed, rms_norm


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


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    """z, x, B, C, dt along the last axis (views, no copy)."""
    di, G, N, H = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    return torch.split(zxbcdt, [di, di, G * N, G * N, H], dim=-1)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, then SiLU.  xBC (B,S,C) in the model dtype,
    w (K,C) and b (C,) in f32: each product is taken in f32, as in the
    reference, and the taps are summed left to right."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i : i + S, :] * w[i][None, None, :] for i in range(K))
    return F.silu(out + b)


def ssm_block(params, x: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, tuple]:
    """Mamba-2 mixer over a full sequence (prefill).

    Returns (y (B,S,d), carry) where carry = (ssd_state, conv_tail) for
    handing off to incremental decode.
    """
    Bb, S, d = x.shape
    dt0 = x.dtype
    di, G, N, H, Pd = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = _dot_f32(x, params["in_proj"])  # f32
    z, xr, Bm, Cm, dt = _split_proj(cfg, zxbcdt)
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
    y = rms_norm(y * F.silu(z), params["gate_norm"], cfg.norm_eps)
    out = _dot_f32(y, params["out_proj"]).to(dt0)
    # conv tail: last (K-1) *pre-conv* channel values, for incremental decode
    K = cfg.ssm_conv
    _, xr_t, Bm_t, Cm_t, _ = _split_proj(cfg, zxbcdt[:, -(K - 1) :, :])
    conv_tail = torch.cat([xr_t, Bm_t, Cm_t], dim=-1)  # (B,K-1,conv_dim) f32
    return out, (ssd_state, conv_tail)


def ssm_block_decode(params, x: torch.Tensor, cfg: ArchConfig, carry) -> Tuple[torch.Tensor, tuple]:
    """One-token Mamba-2 step.  x (B,1,d); carry (ssd_state, conv_tail).
    Returns (y (B,1,d), (new_state, new_tail)), both new tensors."""
    Bb, S, d = x.shape
    assert S == 1
    dt0 = x.dtype
    di, G, N, H, Pd = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    ssd_state, conv_tail = carry
    zxbcdt = _dot_f32(x, params["in_proj"])
    z, xr, Bm, Cm, dt = _split_proj(cfg, zxbcdt)
    xBC_new = torch.cat([xr, Bm, Cm], dim=-1)  # (B,1,conv_dim) f32
    window = torch.cat([conv_tail, xBC_new], dim=1)  # (B,K,conv_dim)
    w = params["conv_w"].float()
    out = (window * w[None, :, :]).sum(dim=1, keepdim=True)
    xBC = F.silu(out + params["conv_b"].float())
    xr2, Bm2, Cm2 = torch.split(xBC[:, 0], [di, G * N, G * N], dim=-1)
    dtv = F.softplus(dt[:, 0] + params["dt_bias"].float())  # (B,H)
    A = -torch.exp(params["A_log"].float())
    y, ssd_state = ssd_decode_step(
        ssd_state,
        xr2.reshape(Bb, H, Pd),
        dtv,
        A,
        Bm2.reshape(Bb, G, N),
        Cm2.reshape(Bb, G, N),
        params["D"].float(),
    )
    y = y.reshape(Bb, 1, di)
    y = rms_norm((y * F.silu(z)).to(dt0), params["gate_norm"], cfg.norm_eps)
    out = _dot_f32(y, params["out_proj"]).to(dt0)
    return out, (ssd_state, window[:, 1:, :])


def ssm_empty_carry(cfg: ArchConfig, batch: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero (ssd_state (B,H,P,N), conv_tail (B,K-1,conv_dim)), both f32."""
    di, G, N, H, Pd = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    conv_dim = di + 2 * G * N
    return (
        torch.zeros((batch, H, Pd, N), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=torch.float32, device=device),
    )
