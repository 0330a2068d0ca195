"""Pieces the references share: RMSNorm, rotary embeddings, and the matrix
product, which the control computes in fp8 instead of float32 and a
screen of many requests in bfloat16."""
from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def fp8_round(t: torch.Tensor, straight_through: bool = False) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one per-tensor scale (amax / 448),
    back in float32.  ``straight_through`` passes the gradient as if the
    rounding were not there, as fp8 training does."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t).detach() if straight_through else q


class Precision:
    """How the reference multiplies matrices: "float32" (TF32 off); "fp8",
    both operands of every projection rounded to float8 e4m3 first (the
    control); or "bfloat16", the operands of every projection and of
    attention's two products in bfloat16, accumulated in float32, attention's
    scores and probabilities kept in bfloat16 (the softmax computed in
    float32), and the rest of the math in float32."""

    def __init__(self, name: str = "float32", straight_through: bool = False):
        if name not in ("float32", "fp8", "bfloat16"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.straight_through = straight_through

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.name == "bfloat16":
            return (x.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()
        x, w = x.float(), w.float()
        if self.name == "fp8":
            x, w = fp8_round(x, self.straight_through), fp8_round(w, self.straight_through)
        return x @ w

    def einsum(self, spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Attention's products: in float32, or in and out in bfloat16 for "bfloat16"."""
        if self.name == "bfloat16":
            return torch.einsum(spec, a.to(torch.bfloat16), b.to(torch.bfloat16))
        return torch.einsum(spec, a, b)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, theta: float, offset: int = 0) -> torch.Tensor:
    """Rotary embedding of x (B, S, heads, hd), position = offset + index,
    over the two halves of each head (the llama / mistral convention)."""
    B, S, _, hd = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = (offset + torch.arange(S, dtype=torch.float32, device=x.device))[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    a, b = x[..., : hd // 2], x[..., hd // 2 :]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def no_tf32() -> None:
    """Float32 products in float32 (TF32 rounds their operands to 10 bits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def worst(*values: float) -> float:
    """The largest of ``values``, or NaN where any is NaN (Python's ``max``
    keeps or drops a NaN by its place)."""
    return float("nan") if any(v != v for v in values) else max(values)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, both taken in float64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-300))

