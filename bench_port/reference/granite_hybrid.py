"""Plain float32 reference of IBM Granite 4.0-H (``granitemoehybrid``):
token embedding times ``embedding_multiplier``; per layer, at position
``l % len(period)`` of the period, RMSNorm, its token mixer (grouped-query
attention without rotary embeddings at the softmax scale
``attention_multiplier``, or the Mamba-2 mixer) and a residual that adds the
mixer's output times ``residual_multiplier``; then RMSNorm, the mixture of
experts and the shared expert, and the same residual; a final RMSNorm and a
head tied to the embedding, its logits divided by ``logits_scaling``.

The mixture of experts is GraniteMoe's: the router's float32 logits, their
top ``top_k``, a softmax over those, and each chosen SwiGLU expert computed
for the tokens that chose it (every routed token, no capacity); the shared
SwiGLU expert of ``shared_intermediate_size`` runs on every token and adds
to it.  The Mamba-2 mixer is ``mamba2.py``'s (one group of B and C, a conv
with a bias, the gated RMSNorm over the whole inner width) through its
``scan``.  Decode caches are reported by absolute layer: ``k`` and ``v``
(without rotary) for attention, ``state`` and ``conv`` for an SSM layer.

Weights arrive as the benchmark's flat dict of leaves (stacked over the
repetitions of the period), in any float dtype; all math is float32, or
fp8 products for the control, or bfloat16 products for a screen
(``common.Precision``).  One layer at a time, one kv head at a time in
attention, one expert at a time in the mixture.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from bench_port.reference.common import Precision, rms_norm, rope
from bench_port.reference.mamba2 import scan


class GraniteHybridRef:
    def __init__(self, cfg: dict, W: Dict[str, torch.Tensor], prec: Optional[Precision] = None):
        if cfg["ssm_groups"] != 1:
            raise ValueError("the reference takes one group of B and C")
        self.cfg, self.W = cfg, W
        self.prec = prec or Precision()

    def layer_weights(self, l: int) -> Dict[str, torch.Tensor]:
        n = len(self.cfg["period"])
        pre = f"stack/pos{l % n}/"
        return {k[len(pre):]: v[l // n] for k, v in self.W.items() if k.startswith(pre)}

    def scale(self) -> float:
        cfg = self.cfg
        mult = cfg.get("attention_multiplier")
        return cfg["head_dim"] ** -0.5 if mult is None else mult

    def attention(self, w, h):
        """Attention over h (B,S,d) f32: (output, {"k", "v"})."""
        cfg, prec = self.cfg, self.prec
        B, S, _ = h.shape
        H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
        q = prec.mm(h, w["mixer/wq"]).view(B, S, H, hd)
        k = prec.mm(h, w["mixer/wk"]).view(B, S, KV, hd)
        v = prec.mm(h, w["mixer/wv"]).view(B, S, KV, hd)
        if cfg.get("position_embedding_type", "rope") == "rope":
            q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
        G = H // KV
        i = torch.arange(S, device=h.device)
        ok = i[None, :] <= i[:, None]
        outs = []
        for j in range(KV):
            s = prec.einsum("bqgh,bkh->bgqk", q[:, :, j * G : (j + 1) * G], k[:, :, j]) * self.scale()
            p = torch.softmax(s.float().masked_fill(~ok, float("-inf")), dim=-1)
            outs.append(prec.einsum("bgqk,bkh->bqgh", p, v[:, :, j]).float())
        return prec.mm(torch.cat(outs, dim=2).reshape(B, S, H * hd), w["mixer/wo"]), {"k": k, "v": v}

    def mamba(self, w, h):
        """The Mamba-2 mixer over h (B,S,d) f32: (output, {"state", "conv"})."""
        cfg = self.cfg
        Bb, S, d = h.shape
        di = cfg["ssm_expand"] * d
        P, N, K = cfg["ssm_head_dim"], cfg["ssm_state"], cfg["ssm_conv"]
        H = di // P
        z, xbc, dt = torch.split(self.prec.mm(h, w["mixer/in_proj"]), [di, di + 2 * N, H], dim=-1)
        cw, cb = w["mixer/conv_w"].float(), w["mixer/conv_b"].float()
        padded = F.pad(xbc, (0, 0, K - 1, 0))
        conv = cb + sum(padded[:, i : i + S] * cw[i] for i in range(K))
        xs, Bm, Cm = torch.split(F.silu(conv), [di, N, N], dim=-1)
        dtv = F.softplus(dt + w["mixer/dt_bias"].float())
        xh = xs.reshape(Bb, S, H, P)
        y, state = scan(xh, dtv, -torch.exp(w["mixer/A_log"].float()), Bm, Cm)
        y = y + xh * w["mixer/D"].float()[:, None]
        y = rms_norm(y.reshape(Bb, S, di) * F.silu(z), w["mixer/gate_norm"], cfg["norm_eps"])
        return self.prec.mm(y, w["mixer/out_proj"]), {"state": state, "conv": xbc[:, S - (K - 1) :]}

    def swiglu(self, h, w_gate, w_up, w_down):
        mm = self.prec.mm
        return mm(F.silu(mm(h, w_gate)) * mm(h, w_up), w_down)

    def moe(self, w, h):
        """The routed experts and the shared expert over h (B,S,d) f32."""
        cfg = self.cfg
        flat = h.reshape(-1, h.shape[-1])
        top, idx = torch.topk(self.prec.mm(flat, w["mlp/router"]), cfg["top_k"], dim=-1)
        gates = torch.softmax(top, dim=-1)
        out = torch.zeros_like(flat)
        for e in range(cfg["n_experts"]):
            tok, slot = (idx == e).nonzero(as_tuple=True)
            if tok.numel():
                y = self.swiglu(flat[tok], w["mlp/w_gate"][e], w["mlp/w_up"][e], w["mlp/w_down"][e])
                out.index_add_(0, tok, y * gates[tok, slot, None])
        if cfg.get("shared_intermediate_size", 0):
            out = out + self.swiglu(flat, w["mlp/shared_gate"], w["mlp/shared_up"], w["mlp/shared_down"])
        return out.view(h.shape)

    def hidden(self, tokens: torch.Tensor, on_cache: Optional[Callable] = None) -> torch.Tensor:
        """The last layer's output (B, S, d) f32 over prompts (B, S)."""
        cfg = self.cfg
        eps, rm = cfg["norm_eps"], cfg.get("residual_multiplier", 1.0)
        x = self.W["embed"][tokens].float() * cfg.get("embedding_multiplier", 1.0)
        for l in range(cfg["n_layers"]):
            i = l % len(cfg["period"])
            w = self.layer_weights(l)
            h = rms_norm(x, w["norm1"], eps)
            y, cache = self.attention(w, h) if cfg["period"][i] == "attn" else self.mamba(w, h)
            x = x + rm * y
            if on_cache is not None:
                on_cache(l, cache)
            kind = cfg["mlp_pattern"][i]
            if kind != "none":
                h = rms_norm(x, w["norm2"], eps)
                if kind == "moe":
                    x = x + rm * self.moe(w, h)
                else:
                    x = x + rm * self.swiglu(h, w["mlp/w_gate"], w["mlp/w_up"], w["mlp/w_down"])
        return x

    def head(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        w = self.W["embed"].T if cfg.get("tie_embeddings", False) else self.W["head"]
        h = rms_norm(x, self.W["final_norm"], cfg["norm_eps"])
        return self.prec.mm(h, w) / cfg.get("logits_scaling", 1.0)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, on_cache: Optional[Callable] = None) -> torch.Tensor:
        """Last-position logits (B, V) of prompts (B, S); ``on_cache(l,
        entries)`` sees each layer's cache entries."""
        return self.head(self.hidden(tokens, on_cache)[:, -1])

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor, last: int) -> torch.Tensor:
        """The full forward's logits (B, last, V) at the last ``last`` positions."""
        return self.head(self.hidden(tokens)[:, -last:])
