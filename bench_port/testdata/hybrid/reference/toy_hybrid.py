"""Plain float32 reference of the toy hybrid: token embedding; per layer,
at position ``l % len(period)`` of the period, RMSNorm and its token mixer
(grouped-query attention with rotary embeddings, or the Mamba-2 mixer)
and a residual, then, unless the position has none, RMSNorm, its channel
mixer (a SwiGLU MLP, or a mixture of experts: softmax router, the top_k
experts' weights renormalised, every routed token computed) and a
residual; a final RMSNorm and an untied head.  Its decode caches are
reported by absolute layer."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from bench_port.reference.common import Precision, rms_norm, rope
from bench_port.reference.dense import DenseRef
from bench_port.reference.mamba2 import Mamba2Ref


class HybridRef:
    def __init__(self, cfg: dict, W: Dict[str, torch.Tensor], prec: Optional[Precision] = None):
        self.cfg, self.W = cfg, W
        self.prec = prec or Precision()
        self.dense, self.ssm = DenseRef(cfg, W, self.prec), Mamba2Ref(cfg, W, self.prec)

    def layer_weights(self, l: int) -> Dict[str, torch.Tensor]:
        pre = f"stack/pos{l % len(self.cfg['period'])}/"
        p = l // len(self.cfg["period"])
        return {k[len(pre):]: v[p] for k, v in self.W.items() if k.startswith(pre)}

    def attention(self, w, x):
        cfg, mm = self.cfg, self.prec.mm
        B, S, _ = x.shape
        H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
        h = rms_norm(x, w["norm1"], cfg["norm_eps"])
        q = rope(mm(h, w["mixer/wq"]).view(B, S, H, hd), cfg["rope_theta"])
        k = rope(mm(h, w["mixer/wk"]).view(B, S, KV, hd), cfg["rope_theta"])
        v = mm(h, w["mixer/wv"]).view(B, S, KV, hd)
        return x + mm(self.dense.attend(q, k, v).reshape(B, S, H * hd), w["mixer/wo"]), {"k": k, "v": v}

    def moe(self, w, h):
        mm = self.prec.mm
        probs = torch.softmax(mm(h, w["mlp/router"]), dim=-1)
        top_w, top_i = torch.topk(probs, self.cfg["top_k"], dim=-1)
        top_w = top_w / top_w.sum(-1, keepdim=True)
        out = torch.zeros_like(h)
        for e in range(self.cfg["n_experts"]):
            gate = (top_w * (top_i == e)).sum(-1, keepdim=True)
            y = mm(F.silu(mm(h, w["mlp/w_gate"][e])) * mm(h, w["mlp/w_up"][e]), w["mlp/w_down"][e])
            out = out + gate * y
        return out

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, on_cache: Optional[Callable] = None) -> torch.Tensor:
        cfg, mm = self.cfg, self.prec.mm
        x = self.W["embed"][tokens].float()
        for l in range(cfg["n_layers"]):
            i = l % len(cfg["period"])
            w = self.layer_weights(l)
            if cfg["period"][i] == "attn":
                x, cache = self.attention(w, x)
            else:
                x, state, tail = self.ssm.layer(w, x)
                cache = {"state": state, "conv": tail}
            if on_cache is not None:
                on_cache(l, cache)
            kind = cfg["mlp_pattern"][i]
            if kind != "none":
                h = rms_norm(x, w["norm2"], cfg["norm_eps"])
                if kind == "moe":
                    x = x + self.moe(w, h)
                else:
                    x = x + mm(F.silu(mm(h, w["mlp/w_gate"])) * mm(h, w["mlp/w_up"]), w["mlp/w_down"])
        h = rms_norm(x[:, -1], self.W["final_norm"], cfg["norm_eps"])
        return mm(h, self.W["head"])
