"""Plain float32 reference of a Mamba-2 (SSD) language model: token
embedding, then per layer RMSNorm, the Mamba-2 mixer and a residual; a
final RMSNorm and a head tied to the embedding.

The mixer: one input projection to (z, x, B, C, dt); a depthwise causal
convolution over (x, B, C) with a bias, then SiLU; dt = softplus(dt +
dt_bias), A = -exp(A_log); the selective scan

    S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_tᵀ,    y_t = S_t C_t + D x_t,

computed exactly in blocks of 64 steps (within a block from the cumulative
decays, across blocks by carrying S); y gated by SiLU(z), an RMSNorm over
the inner width, and the output projection.  The decode cache it hands on
is S after the last step and the last K-1 rows of the convolution's input.
Weights arrive as the benchmark's flat dict of leaves; math is float32, or
fp8 products for the control.  Training's gradients (``loss_and_grads``)
recompute each layer under autograd from its kept input, as the dense
reference's do.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from bench_port.reference.common import Precision, rms_norm

P0 = "stack/pos0/"
BLOCK = 64


def scan(x, dt, A, Bm, Cm, block: int = BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,N): (y without D x, S_last (B,H,P,N))."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    state = x.new_zeros((Bb, H, P, N))
    ys = []
    for s0 in range(0, S, block):
        sl = slice(s0, min(S, s0 + block))
        a = torch.cumsum(dt[:, sl] * A, dim=1)  # (B,Q,H)
        Q = a.shape[1]
        tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
        decay = torch.exp((a[:, :, None, :] - a[:, None, :, :]).masked_fill(~tri[None, :, :, None], float("-inf")))
        cb = torch.einsum("bin,bjn->bij", Cm[:, sl], Bm[:, sl])  # (B,Qi,Qj)
        w = cb[..., None] * decay * dt[:, sl][:, None, :, :]  # (B,Qi,Qj,H)
        y = torch.einsum("bijh,bjhp->bihp", w, x[:, sl])
        y = y + torch.einsum("bhpn,bin->bihp", state, Cm[:, sl]) * torch.exp(a)[..., None]
        tail = torch.exp(a[:, -1:, :] - a) * dt[:, sl]  # (B,Q,H)
        state = state * torch.exp(a[:, -1])[..., None, None] + torch.einsum(
            "bjh,bjhp,bjn->bhpn", tail, x[:, sl], Bm[:, sl]
        )
        ys.append(y)
    return torch.cat(ys, dim=1), state


class Mamba2Ref:
    def __init__(self, cfg: dict, W: Dict[str, torch.Tensor], prec: Optional[Precision] = None):
        if cfg["ssm_groups"] != 1:
            raise ValueError("the reference takes one group of B and C")
        self.cfg, self.W = cfg, W
        self.prec = prec or Precision()

    def layer_weights(self, l: int) -> Dict[str, torch.Tensor]:
        return {k[len(P0):]: v[l] for k, v in self.W.items() if k.startswith(P0)}

    def layer(self, w: Dict[str, torch.Tensor], x: torch.Tensor):
        """One layer over x (B,S,d) f32: (output, final state, conv tail)."""
        cfg = self.cfg
        Bb, S, d = x.shape
        di = cfg["ssm_expand"] * d
        P, N, K = cfg["ssm_head_dim"], cfg["ssm_state"], cfg["ssm_conv"]
        H = di // P
        h = rms_norm(x, w["norm1"], cfg["norm_eps"])
        zxbcdt = self.prec.mm(h, w["mixer/in_proj"])
        z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
        cw, cb = w["mixer/conv_w"].float(), w["mixer/conv_b"].float()
        padded = F.pad(xbc, (0, 0, K - 1, 0))
        conv = cb + sum(padded[:, i : i + S] * cw[i] for i in range(K))
        xs, Bm, Cm = torch.split(F.silu(conv), [di, N, N], dim=-1)
        dtv = F.softplus(dt + w["mixer/dt_bias"].float())
        A = -torch.exp(w["mixer/A_log"].float())
        xh = xs.reshape(Bb, S, H, P)
        y, state = scan(xh, dtv, A, Bm, Cm)
        y = y + xh * w["mixer/D"].float()[:, None]
        y = rms_norm(y.reshape(Bb, S, di) * F.silu(z), w["mixer/gate_norm"], cfg["norm_eps"])
        return x + self.prec.mm(y, w["mixer/out_proj"]), state, xbc[:, S - (K - 1) :]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, on_cache: Optional[Callable] = None) -> torch.Tensor:
        """Last-position logits (B, V) of prompts (B, S); ``on_cache(l,
        {"state": S, "conv": tail})`` sees each layer's cache entries."""
        x = self.W["embed"][tokens].float()
        for l in range(self.cfg["n_layers"]):
            x, state, tail = self.layer(self.layer_weights(l), x)
            if on_cache is not None:
                on_cache(l, {"state": state, "conv": tail})
        h = rms_norm(x[:, -1], self.W["final_norm"], self.cfg["norm_eps"])
        return self.prec.mm(h, self.W["embed"].T)

    def loss_and_grads(self, tokens: torch.Tensor, labels: torch.Tensor) -> Tuple[float, Dict[str, torch.Tensor]]:
        """Mean cross entropy over every position, and its gradient for
        every leaf (f32, stacked like the leaves); the tied embedding's
        gradient sums the head's and the lookup's.  The layers' inputs are
        kept; each layer is recomputed under autograd on the way back."""
        cfg, L = self.cfg, self.cfg["n_layers"]
        grads = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device) for k, v in self.W.items()}
        xs: List[torch.Tensor] = []
        with torch.no_grad():
            x = self.W["embed"][tokens].float()
            for l in range(L):
                xs.append(x)
                x = self.layer(self.layer_weights(l), x)[0]
        x = x.detach().requires_grad_(True)
        fn = self.W["final_norm"].float().requires_grad_(True)
        emb = self.W["embed"].float().requires_grad_(True)
        h = rms_norm(x, fn, cfg["norm_eps"])
        logits = self.prec.mm(h, emb.T)
        loss = F.cross_entropy(logits.view(-1, logits.shape[-1]), labels.reshape(-1))
        gx, gfn, gemb = torch.autograd.grad(loss, (x, fn, emb))
        grads["final_norm"] += gfn
        grads["embed"] += gemb
        del logits, h, emb, gemb
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
