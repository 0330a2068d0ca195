"""Primitive layers: norms, RoPE, GQA attention (flash-style chunked), MLPs.

The PyTorch port of ``repro.models.layers``.  Every layer is a plain function
``f(params, x, cfg, ...)`` over tensors; ``params`` is anything indexable by
the reference's leaf names (a dict or an ``nn.ParameterDict``).  Weights keep
the reference's ``(in, out)`` orientation, so a projection is ``x @ W``.
Products accumulate in f32 and activations stay in the config dtype, as the
reference's ``preferred_element_type=jnp.float32`` einsums do.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ArchConfig
from repro_torch.models.parallel import (
    MeshContext,
    attn_even,
    attn_split,
    gather_over_model,
    head_runs,
    into_region,
    kv_heads_read,
    kv_split,
    mlp_split,
    model_size,
    out_of_region,
)


def _dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with an f32 result from products summed in f32 — the port of
    ``einsum(..., preferred_element_type=jnp.float32)``.  On the card a bf16
    product stays a bf16 GEMM that writes f32 (``mm`` with ``out_dtype``); on
    the CPU the operands are widened to f32 first."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        x2 = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            out = _MmF32.apply(x2, w)
        else:  # serving: a bare mm; the Function costs 0.8-2.4 ms of host time
            # a decode step on an H100 (chip_smoke.py, line `dot_f32_branch`)
            out = torch.mm(x2, w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


class _MmF32(torch.autograd.Function):
    """``mm`` with ``out_dtype=float32`` and a derivative: the backward runs
    two GEMMs of the same kind on the gradient cast to the operands' dtype
    (never widening the operands, which would leave the tensor cores) and
    casts their f32 results to the operands' dtypes."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        a, b = ctx.saved_tensors
        g = grad.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.mm(g, b.T, out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.mm(a.T, g, out_dtype=torch.float32).to(b.dtype)
        return ga, gb


def checkpointed(fn, *args, **kwargs):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (the port of
    ``jax.checkpoint``) while autograd records; a plain call otherwise, so
    serving never pays for it.  ``kwargs`` go to the checkpoint
    (``context_fn``)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return fn(*args)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (S,) or broadcastable to (..., S).
    Rotates split halves (not interleaved pairs), in f32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)  # (hd/2,)
    angles = positions[..., :, None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AttnMask:
    causal: bool
    window: Optional[int] = None  # keys with qpos - kpos >= window are masked
    kv_len: Optional[torch.Tensor] = None  # valid KV prefix length (decode padding)


def _mask_block(qpos: torch.Tensor, kpos: torch.Tensor, m: AttnMask) -> torch.Tensor:
    """Boolean (…, Sq, Sk) mask block from absolute positions."""
    ok = torch.ones((qpos.shape[-1], kpos.shape[-1]), dtype=torch.bool, device=qpos.device)
    if m.causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if m.window is not None:
        ok &= kpos[None, :] > (qpos[:, None] - m.window)
    if m.kv_len is not None:
        # kv_len broadcasts per batch: (B, 1, 1) vs (Sq, Sk)
        ok = ok[None] & (kpos[None, None, :] < m.kv_len[:, None, None])
    return ok


def _heads_out(o: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, KV, G, Sq, hd) -> (B, Sq, H, hd) in ``dtype``."""
    B, KV, G, Sq, hd = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, KV * G, hd).to(dtype)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: AttnMask,
    *,
    chunk: int = 1024,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash-style attention: a loop over KV chunks with an online softmax.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with H = KV * G (GQA).  ``p`` is
    cast to ``v.dtype`` before the PV product, as the reference does; the
    statistics m/l and the accumulator stay f32.  The scores' scale is
    ``scale``, hd ** -0.5 by default.
    """
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    scale = hd ** -0.5 if scale is None else scale
    qg = (q * scale).reshape(B, Sq, KV, G, hd).float()
    n_chunks = -(-Sk // chunk)
    pad = n_chunks * chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qpos = q_offset + torch.arange(Sq, device=q.device)
    m_i = torch.full((B, KV, G, Sq), -torch.inf, dtype=torch.float32, device=q.device)
    l_i = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=q.device)
    for j in range(n_chunks):
        k_j = k[:, j * chunk : (j + 1) * chunk]
        v_j = v[:, j * chunk : (j + 1) * chunk]
        kpos = j * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqkgh,bckh->bkgqc", qg, k_j.float())  # (B, KV, G, Sq, chunk)
        ok = _mask_block(qpos, kpos, mask) & (kpos < Sk)  # exclude right padding
        okb = ok[None, None, None] if ok.ndim == 2 else ok[:, None, None]
        s = s.masked_fill(~okb, -torch.inf)
        m_new = torch.maximum(m_i, s.amax(dim=-1))
        # Rows with no valid key yet keep m=-inf; guard exp(-inf - -inf).
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None]).masked_fill(~okb, 0.0)
        alpha = torch.where(torch.isneginf(m_i), 0.0, torch.exp(m_i - m_safe))
        l_i = l_i * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgqc,bckh->bkgqh", p.to(v_j.dtype).float(), v_j.float())
        acc = acc * alpha[..., None] + pv
        m_i = m_new
    out = acc / torch.clamp_min(l_i, 1e-30)[..., None]
    return _heads_out(out, q.dtype)


def plain_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: AttnMask, q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Direct softmax attention (oracle for tests; decode path); the scores'
    scale is ``scale``, hd ** -0.5 by default."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    qg = (q * (hd ** -0.5 if scale is None else scale)).reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    qpos = q_offset + torch.arange(Sq, device=q.device)
    ok = _mask_block(qpos, torch.arange(Sk, device=q.device), mask)
    okb = ok[None, None, None] if ok.ndim == 2 else ok[:, None, None]
    s = s.masked_fill(~okb, -torch.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # fully-masked rows
    o = torch.einsum("bkgqs,bskh->bkgqh", p, v.float())
    return _heads_out(o, q.dtype)


def _head_cols(w: torch.Tensor, lo: int, hi: int, hd: int) -> torch.Tensor:
    """The last-dim entries of ``w`` (a projection's columns or a bias) of
    heads [lo, hi)."""
    return w.narrow(-1, lo * hd, (hi - lo) * hd)


def _kv_run(t: torch.Tensor, lo: int, hi: int, first: int, n_all: int) -> torch.Tensor:
    """kv heads [lo, hi) of ``t`` (B, S, n, hd), which holds all ``n_all``
    or exactly the heads from ``first`` on: a view, never a copy."""
    first = 0 if t.shape[2] == n_all else first
    if (lo - first, hi - first) == (0, t.shape[2]):
        return t
    return t.narrow(2, lo - first, hi - lo)


def _by_runs(core, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: ArchConfig,
             h0: int, h1: int, k0: int) -> torch.Tensor:
    """``core(q, k, v)`` for query heads [h0, h1), once for each of their
    ``head_runs`` on views of q and of the kv heads it reads (``k``/``v``
    hold every kv head or this rank's from ``k0`` on), the outputs joined on
    the head axis."""
    outs = []
    for r0, r1 in head_runs(cfg, h0, h1):
        c0, c1 = kv_heads_read(cfg, r0, r1)
        q_run = q if (r0, r1) == (h0, h1) else q.narrow(2, r0 - h0, r1 - r0)
        kv = [_kv_run(t, c0, c1, k0, cfg.n_kv_heads) for t in (k, v)]
        outs.append(core(q_run, *kv))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def attention_block(
    params,
    x: torch.Tensor,
    cfg: ArchConfig,
    *,
    positions: torch.Tensor,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_pos: Optional[int] = None,
    kv_len: Optional[torch.Tensor] = None,
    ctx: Optional[MeshContext] = None,
    full_kv: bool = False,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full attention sub-layer: qkv proj, rope (unless the configuration's
    ``position_embedding_type`` is "nope"), SDPA at ``cfg.softmax_scale``,
    out proj.

    Prefill: ``kv_cache=None`` — attends within ``x`` and returns the roped
    K/V it made, which are the decode cache's entries for these positions.
    Decode: ``kv_cache=(K, V)`` of shape (B, S_max, KV, hd); the new token's
    K/V are written at ``cache_pos`` IN PLACE (the reference returns an
    updated copy) and attention runs over the cache, which is returned.

    Under a ``ctx`` whose model axis splits the heads (``attn_split``) the
    block is tensor-parallel on this rank's query heads [h0, h1)
    (``MeshContext.heads``): ``wq``/``bq`` hold their columns and ``wo``
    their rows under the even split (``attn_even``), else they are whole
    and the rank takes its heads' columns and rows; ``wk/wv/bk/bv`` hold its kv
    heads' columns (``kv_split``) or are whole, and the rank takes the
    columns of the kv heads it reads (all of them where ``full_kv`` asks for
    every head's K/V, as the prefill's cache does, or a decode cache holds
    every head).  The core runs once for each of the heads' ``head_runs``,
    the ``wo`` product's f32 partial sums are all-reduced over the model
    group, then cast.  A decode cache holds this rank's kv heads (written in
    place) or every kv head (the new token's K/V of every head written; a
    split K/V gathered over the model group first)."""
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    split = attn_split(cfg, model_size(ctx))
    wq, wo, wk, wv = params["wq"], params["wo"], params["wk"], params["wv"]
    bq, bk, bv = (params["bq"], params["bk"], params["bv"]) if cfg.qkv_bias else (None, None, None)
    (h0, h1), (k0, k1) = (0, H), (0, KV)
    if split:
        x = into_region(x, ctx)
        h0, h1 = ctx.heads(H)
        if not attn_even(cfg, ctx.model_size):  # whole leaves: this rank's heads of them
            wq, wo = _head_cols(wq, h0, h1, hd), wo.narrow(0, h0 * hd, (h1 - h0) * hd)
            if cfg.qkv_bias:
                bq = _head_cols(bq, h0, h1, hd)
        if kv_split(cfg, ctx.model_size):
            k0, k1 = ctx.part(KV)
        else:
            k0, k1 = kv_heads_read(cfg, h0, h1)
            every = full_kv or (kv_cache is not None and kv_cache[0].shape[2] == KV)
            m0, m1 = (0, KV) if every else (k0, k1)
            wk, wv = _head_cols(wk, m0, m1, hd), _head_cols(wv, m0, m1, hd)
            if cfg.qkv_bias:
                bk, bv = _head_cols(bk, m0, m1, hd), _head_cols(bv, m0, m1, hd)
    q = _dot_f32(x, wq)
    k = _dot_f32(x, wk)
    v = _dot_f32(x, wv)
    if cfg.qkv_bias:
        q = q + bq
        k = k + bk
        v = v + bv
    q = q.to(dt).reshape(B, S, h1 - h0, hd)
    k = k.to(dt).reshape(B, S, -1, hd)
    v = v.to(dt).reshape(B, S, -1, hd)
    if cfg.position_embedding_type == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    scale = cfg.softmax_scale

    if kv_cache is None:
        cache = (k, v)
        mask = AttnMask(causal=cfg.causal, window=cfg.window)
        if cfg.use_kernels:
            from repro_torch.kernels import ops  # lazy: no cycle

            def core(q, k, v):
                return ops.flash_attention(q, k, v, causal=cfg.causal, window=cfg.window, scale=scale)
        elif S > cfg.attn_chunk:
            def core(q, k, v):
                return chunked_attention(q, k, v, mask, chunk=cfg.attn_chunk, scale=scale)
        else:
            def core(q, k, v):
                return plain_attention(q, k, v, mask, scale=scale)
    else:
        K, V = kv_cache
        assert cache_pos is not None
        if K.shape[2] != k.shape[2]:  # a cache of every kv head: gather the split heads' K/V
            k, v = gather_over_model(k, ctx, 2), gather_over_model(v, ctx, 2)
        K[:, cache_pos : cache_pos + S] = k
        V[:, cache_pos : cache_pos + S] = v
        cache = k, v = K, V
        mask = AttnMask(causal=cfg.causal, window=cfg.window, kv_len=kv_len)

        def core(q, k, v):  # query absolute position == its cache slot
            return plain_attention(q, k, v, mask, q_offset=cache_pos, scale=scale)
    out = _by_runs(core, q, k, v, cfg, h0, h1, k0)
    y = _dot_f32(out.reshape(B, S, (h1 - h0) * hd), wo)
    if split:
        y = out_of_region(y, ctx)  # the f32 partial sums, then the cast
    return y.to(dt), cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def mlp_block(params, x: torch.Tensor, cfg: ArchConfig, ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """The dense MLP; under a ``ctx`` whose model axis splits d_ff
    (``mlp_split``) the leaves hold this rank's d_ff slice and the
    ``w_down`` product's f32 partial sums are all-reduced, then cast."""
    dt = x.dtype
    split = mlp_split(cfg, model_size(ctx))
    if split:
        x = into_region(x, ctx)
    if cfg.mlp_act == "swiglu":
        g = _dot_f32(x, params["w_gate"])
        u = _dot_f32(x, params["w_up"])
        h = (F.silu(g) * u).to(dt)
    else:  # gelu: classic 2-matrix MLP (encoder stacks); jax.nn.gelu is tanh
        u = _dot_f32(x, params["w_up"])
        h = F.gelu(u, approximate="tanh").to(dt)
    y = _dot_f32(h, params["w_down"])
    if split:
        y = out_of_region(y, ctx)
    return y.to(dt)


# ---------------------------------------------------------------------------
# Parameter initialization helpers
# ---------------------------------------------------------------------------
def dense_init(
    generator: Optional[torch.Generator],
    shape: Tuple[int, ...],
    dtype: torch.dtype,
    fan_in: int,
    device=None,
) -> torch.Tensor:
    """N(0, 1/fan_in) drawn in f32 on ``device``, cast to ``dtype``.

    A leaf of more than two axes (a stacked or expert leaf) is drawn one
    matrix at a time straight into the leaf in ``dtype``, so the f32
    transient is one matrix, not the leaf: phi3.5-moe's stacked ``w_gate``
    would take 40 GB in f32.  On the CPU the values are those of one draw of
    the whole leaf whenever a matrix's size is a multiple of 16 (torch fills
    normals 16 at a time)."""
    if len(shape) > 2:
        out = torch.empty(shape, dtype=dtype, device=device)
        for idx in itertools.product(*map(range, shape[:-2])):
            out[idx] = dense_init(generator, shape[-2:], dtype, fan_in, device)
        return out
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return w.mul_(fan_in ** -0.5).to(dtype)


def attn_param_shapes(cfg: ArchConfig) -> dict:
    q = cfg.n_heads * cfg.head_dim
    kv = cfg.n_kv_heads * cfg.head_dim
    d = cfg.d_model
    shapes = {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d)}
    if cfg.qkv_bias:
        shapes.update({"bq": (q,), "bk": (kv,), "bv": (kv,)})
    return shapes


def mlp_param_shapes(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_act == "swiglu":
        return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    return {"w_up": (d, f), "w_down": (f, d)}
