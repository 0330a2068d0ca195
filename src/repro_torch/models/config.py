"""Architecture configuration: one frozen dataclass describes every model in
the zoo (dense / MoE / SSM / hybrid / encoder-only / VLM-backbone).

A model is a stack of ``n_layers`` layers organized as ``n_layers / len(period)``
repeating *periods*.  ``period[i]`` names the token mixer of position ``i``
("attn" or "ssm"); ``mlp_pattern[i]`` names its channel mixer ("mlp", "moe"
or "none").  Homogeneous models use a period of length 1; Jamba's 1:7
attention:Mamba interleave with MoE every other layer is a period of 8.

This is the PyTorch port's own copy of ``repro.models.config``: every field
keeps its name except ``use_pallas``, which is ``use_kernels`` here, and
``jnp_dtype`` becomes ``torch_dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_kv_heads: int = 0  # 0 => MHA (== n_heads)
    head_dim: int = 0  # 0 => d_model // n_heads

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # --- attention ----------------------------------------------------------
    window: Optional[int] = None  # sliding-window size (None = full)
    causal: bool = True  # False => bidirectional encoder
    rope_theta: float = 10_000.0
    attn_chunk: int = 1024  # kv-chunk for flash-style chunked attention
    qkv_bias: bool = False

    # --- SSM (Mamba-2 / SSD) --------------------------------------------------
    ssm_state: int = 0  # N
    ssm_expand: int = 2
    ssm_head_dim: int = 64  # P
    ssm_groups: int = 1  # G
    ssm_conv: int = 4
    ssm_chunk: int = 128  # SSD chunk length Q

    # --- layer pattern --------------------------------------------------------
    period: Tuple[str, ...] = ("attn",)
    mlp_pattern: Tuple[str, ...] = ("mlp",)
    mlp_act: str = "swiglu"  # swiglu (3 mats) | gelu (2 mats)

    # --- embeddings / io -------------------------------------------------------
    frontend: str = "none"  # none | patch (vlm) | frame (audio)
    n_frontend_tokens: int = 0  # patch/frame positions occupied per sample
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # --- kernels ---------------------------------------------------------------
    # Route prefill attention through the hand-written CUDA kernels
    # (kernels/ops.py).  A CUDA tensor launches the kernel; a CPU tensor takes
    # the kernel's plain PyTorch version.  False selects the chunked/plain
    # attention of models/layers.py on either device.
    use_kernels: bool = True

    def __post_init__(self):
        if self.n_kv_heads == 0:
            object.__setattr__(self, "n_kv_heads", self.n_heads)
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if len(self.period) != len(self.mlp_pattern):
            raise ValueError("period and mlp_pattern must have equal length")
        if self.n_layers % len(self.period) != 0:
            raise ValueError(
                f"n_layers={self.n_layers} not divisible by period {len(self.period)}"
            )
        for kind in self.period:
            if kind not in ("attn", "ssm"):
                raise ValueError(f"unknown mixer kind {kind!r}")
        for kind in self.mlp_pattern:
            if kind not in ("mlp", "moe", "none"):
                raise ValueError(f"unknown mlp kind {kind!r}")
        if "moe" in self.mlp_pattern and (self.n_experts < 2 or self.top_k < 1):
            raise ValueError("moe layers need n_experts>=2 and top_k>=1")

    # -- derived -----------------------------------------------------------
    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.period)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def has_attention(self) -> bool:
        return "attn" in self.period

    @property
    def has_ssm(self) -> bool:
        return "ssm" in self.period

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def subquadratic(self) -> bool:
        """True if context cost/token is O(1) or O(window) — the long_500k
        eligibility rule: SSM, hybrid, or sliding-window attention."""
        if not self.has_attention:
            return True
        return self.has_ssm or self.window is not None

    def param_count(self) -> int:
        """Exact parameter count (embeddings included)."""
        total = self.vocab * self.d_model  # embed
        if not self.tie_embeddings:
            total += self.d_model * self.vocab  # head
        total += self.d_model  # final norm
        d, hd = self.d_model, self.head_dim
        for mixer, mlp in zip(self.period, self.mlp_pattern):
            n = self.n_periods
            total += n * d  # norm1
            if mixer == "attn":
                q = self.n_heads * hd
                kv = self.n_kv_heads * hd
                total += n * (d * q + 2 * d * kv + q * d)
                if self.qkv_bias:
                    total += n * (q + 2 * kv)
            else:
                di, g, N, H = self.d_inner, self.ssm_groups, self.ssm_state, self.ssm_heads
                conv_dim = di + 2 * g * N
                total += n * (
                    d * (2 * di + 2 * g * N + H)  # in_proj (x,z,B,C,dt)
                    + conv_dim * self.ssm_conv  # conv
                    + 3 * H  # A_log, D, dt_bias
                    + di  # gated norm
                    + di * d  # out_proj
                )
            if mlp != "none":
                total += n * d  # norm2
            n_mats = 3 if self.mlp_act == "swiglu" else 2
            if mlp == "mlp":
                total += n * n_mats * d * self.d_ff
            elif mlp == "moe":
                total += n * (d * self.n_experts + self.n_experts * n_mats * d * self.d_ff)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if "moe" not in self.mlp_pattern:
            return self.param_count()
        total = self.param_count()
        n_mats = 3 if self.mlp_act == "swiglu" else 2
        expert_mats = self.d_model * self.d_ff * n_mats
        for mlp in self.mlp_pattern:
            if mlp == "moe":
                total -= self.n_periods * (self.n_experts - self.top_k) * expert_mats
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (paper-assigned shape sets)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens_per_step(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def applicable_shapes(cfg: ArchConfig) -> Tuple[ShapeConfig, ...]:
    """The dry-run cells for an architecture, per the assignment rules:
    encoder-only archs skip decode shapes; long_500k requires sub-quadratic
    attention (SSM / hybrid / SWA)."""
    out = []
    for s in ALL_SHAPES:
        if s.kind == "decode" and cfg.is_encoder:
            continue
        if s.name == "long_500k" and not cfg.subquadratic:
            continue
        out.append(s)
    return tuple(out)
