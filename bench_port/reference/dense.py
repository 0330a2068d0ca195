"""Plain float32 reference of a dense decoder with grouped-query attention:
token embedding, then per layer RMSNorm, attention (rotary embeddings,
causal with an optional sliding window, kv heads shared by groups of query
heads), a residual, RMSNorm, a SwiGLU MLP and a residual; a final RMSNorm
and an untied head.  Weights arrive as the benchmark's flat dict of leaves
(``bench_port/weights.py``), in any float dtype; all math is float32, or
fp8 products for the control, or bfloat16 products for a screen
(``common.Precision``).

Nothing is cached or fused: one layer at a time, one kv head at a time in
attention, so that the full-size model fits beside its inputs.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from bench_port.reference.common import Precision, rms_norm, rope

P0 = "stack/pos0/"


class DenseRef:
    def __init__(self, cfg: dict, W: Dict[str, torch.Tensor], prec: Optional[Precision] = None):
        self.cfg, self.W = cfg, W
        self.prec = prec or Precision()

    def layer_weights(self, l: int) -> Dict[str, torch.Tensor]:
        return {k[len(P0):]: v[l] for k, v in self.W.items() if k.startswith(P0)}

    def attend(self, q, k, v) -> torch.Tensor:
        """q (B,S,H,hd), k/v (B,S,KV,hd), f32 -> (B,S,H,hd)."""
        cfg = self.cfg
        B, S, H, hd = q.shape
        KV = k.shape[2]
        G = H // KV
        i = torch.arange(S, device=q.device)
        ok = i[None, :] <= i[:, None]
        if cfg.get("window") is not None:
            ok &= i[None, :] > i[:, None] - cfg["window"]
        outs = []
        for j in range(KV):
            qj = q[:, :, j * G : (j + 1) * G]
            s = self.prec.einsum("bqgh,bkh->bgqk", qj, k[:, :, j]) * hd ** -0.5
            s = s.masked_fill(~ok, float("-inf"))
            outs.append(self.prec.einsum("bgqk,bkh->bqgh", torch.softmax(s, dim=-1), v[:, :, j]))
        return torch.cat(outs, dim=2).float()

    def layer(self, w: Dict[str, torch.Tensor], x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One layer over x (B,S,d) f32: (output, roped k, v)."""
        cfg, mm = self.cfg, self.prec.mm
        B, S, d = x.shape
        H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
        h = rms_norm(x, w["norm1"], cfg["norm_eps"])
        q = rope(mm(h, w["mixer/wq"]).view(B, S, H, hd), cfg["rope_theta"])
        k = rope(mm(h, w["mixer/wk"]).view(B, S, KV, hd), cfg["rope_theta"])
        v = mm(h, w["mixer/wv"]).view(B, S, KV, hd)
        x = x + mm(self.attend(q, k, v).reshape(B, S, H * hd), w["mixer/wo"])
        h = rms_norm(x, w["norm2"], cfg["norm_eps"])
        x = x + mm(F.silu(mm(h, w["mlp/w_gate"])) * mm(h, w["mlp/w_up"]), w["mlp/w_down"])
        return x, k, v

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.W["embed"][tokens].float()

    def head(self, x: torch.Tensor) -> torch.Tensor:
        h = rms_norm(x, self.W["final_norm"], self.cfg["norm_eps"])
        return self.prec.mm(h, self.W["head"])

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, on_cache: Optional[Callable] = None) -> torch.Tensor:
        """Last-position logits (B, V) of prompts (B, S); ``on_cache(l,
        {"k": k, "v": v})`` sees each layer's cache entries."""
        x = self.embed(tokens)
        for l in range(self.cfg["n_layers"]):
            x, k, v = self.layer(self.layer_weights(l), x)
            if on_cache is not None:
                on_cache(l, {"k": k, "v": v})
        return self.head(x[:, -1:])[:, 0]

    def loss_and_grads(self, tokens: torch.Tensor, labels: torch.Tensor) -> Tuple[float, Dict[str, torch.Tensor]]:
        """Mean cross entropy over every position, and its gradient for
        every leaf (f32, stacked like the leaves).  The layers' inputs are
        kept; each layer is recomputed under autograd on the way back."""
        cfg, L = self.cfg, self.cfg["n_layers"]
        grads = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device) for k, v in self.W.items()}
        xs: List[torch.Tensor] = []
        with torch.no_grad():
            x = self.embed(tokens)
            for l in range(L):
                xs.append(x)
                x = self.layer(self.layer_weights(l), x)[0]
        x = x.detach().requires_grad_(True)
        fn = self.W["final_norm"].float().requires_grad_(True)
        hw = self.W["head"].float().requires_grad_(True)
        h = rms_norm(x, fn, cfg["norm_eps"])
        logits = self.prec.mm(h, hw)
        loss = F.cross_entropy(logits.view(-1, logits.shape[-1]), labels.reshape(-1))
        gx, gfn, ghw = torch.autograd.grad(loss, (x, fn, hw))
        grads["final_norm"] += gfn
        grads["head"] += ghw
        del logits, h
        for l in reversed(range(L)):
            wl = {k: v.float().requires_grad_(True) for k, v in self.layer_weights(l).items()}
            xin = xs[l].requires_grad_(True)
            out = self.layer(wl, xin)[0]
            gs = torch.autograd.grad(out, (xin, *wl.values()), gx)
            gx = gs[0]
            for name, g in zip(wl, gs[1:]):
                grads[P0 + name][l] += g
            xs[l] = None
        grads["embed"].index_add_(0, tokens.reshape(-1), gx.reshape(-1, gx.shape[-1]))
        return float(loss.detach()), grads
