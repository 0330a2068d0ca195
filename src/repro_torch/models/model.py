"""Full model assembly, every family of the zoo: embeddings -> period stack
-> head / decode state.  The PyTorch port of ``repro.models.model``.

The reference keeps each period position's parameters under
``params["stack"][f"pos{i}"]`` with a leading ``n_periods`` axis and scans
over it.  Here ``DecoderLM`` holds an ``nn.ModuleList`` with one
``nn.ModuleDict`` of ``pos{i}`` blocks per repetition, and the scan is a
Python loop.  Parameter names mirror the
reference's key paths: ``layers.{p}.pos{i}.mixer.wq`` is
``stack/pos{i}/mixer/wq[p]``; weights keep the ``(in, out)`` orientation.

Entry points, as in the reference (``params`` is a ``DecoderLM``):

  init_params / param_shapes      parameter tree (real / meta tensors)
  forward                         token/patch/frame embeddings -> final hidden
  train_loss                      chunked-vocab cross entropy (never
                                  materializes (B,S,V) for the full sequence)
  prefill                         forward + KV/SSM decode state
  init_decode_state / decode_step one-token serving step

The decode caches keep the reference layout at this boundary: per
``pos{i}``, ``k`` and ``v`` of shape (n_periods, B, S, KV, hd) for an
attention position, ``state`` (n_periods, B, H, P, N) and ``conv``
(n_periods, B, K-1, conv_dim), both f32, for an SSM position.
A period position's channel mixer is a dense MLP or an MoE block
(``models/moe.py``), as ``cfg.mlp_pattern`` says.  ``ctx`` (a
``parallel.MeshContext``, None for one process) reaches every mixer and
MLP: ``moe_block`` splits the experts over ``model`` as in the reference,
and attention, the dense MLP and the SSM split their heads or d_ff over it
where it divides them (``models/parallel.py``); so do the embedding
lookup, the head and the cross entropy, on V/m vocabulary rows a rank where
the model axis divides V (``parallel.vocab_split``; the prefill, decode and
encoder logits are then this rank's columns, which the step builders
gather).  Under it ``params`` is a ``distributed.sharding.ShardedLM``'s
``view()``, which gathers each period's parameters on use and keeps the
``model`` shard of a split leaf.  The
frontends are the reference's stubs: a ``"patch"`` config (the VLM) writes
precomputed patch embeddings over its first ``n_frontend_tokens`` token
embeddings, a ``"frame"`` config (the audio encoder) takes precomputed
frame embeddings as its input and has no ``embed`` leaf.

The port's own configuration fields (GraniteMoeHybrid's multipliers) act
here: ``embedding_multiplier`` on the lookup, ``residual_multiplier`` on
each sub-layer's output before its residual add, and ``logits_scaling``
dividing the head's logits.  Each acts only where it is not 1, so every
other model launches what it did without them.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    _dot_f32,
    attention_block,
    attn_param_shapes,
    checkpointed,
    dense_init,
    mlp_block,
    mlp_param_shapes,
    rms_norm,
)
from repro_torch.models.moe import moe_block, moe_param_shapes
from repro_torch.models.parallel import (
    MeshContext,
    into_region,
    vocab_ctx,
    vocab_embed,
    vocab_parallel_nll,
    vocab_range,
)
from repro_torch.models.ssm import (
    ssm_block,
    ssm_block_decode,
    ssm_empty_carry,
    ssm_param_shapes,
)
from repro_torch.obs.spans import span

_F32_LEAVES = ("A_log", "D", "dt_bias")  # small SSM params stay f32


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Asking for CUDA where there is none raises:
    the port never drops to the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU explicitly"
        )
    return dev


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------
def _mixer_shapes(cfg: ArchConfig, kind: str) -> dict:
    return attn_param_shapes(cfg) if kind == "attn" else ssm_param_shapes(cfg)


def _mlp_shapes(cfg: ArchConfig, kind: str) -> dict:
    return moe_param_shapes(cfg) if kind == "moe" else mlp_param_shapes(cfg)


def _position_shapes(cfg: ArchConfig, i: int) -> dict:
    mixer, mlp = cfg.period[i], cfg.mlp_pattern[i]
    shapes = {"norm1": (cfg.d_model,), "mixer": _mixer_shapes(cfg, mixer)}
    if mlp != "none":
        shapes["norm2"] = (cfg.d_model,)
        shapes["mlp"] = _mlp_shapes(cfg, mlp)
    return shapes


def _init_leaf(g, device, name: str, shape, cfg: ArchConfig, stacked: int = 0):
    """One parameter leaf.  ``stacked`` > 0 prepends the period axis."""
    full = (stacked, *shape) if stacked else tuple(shape)
    dt = torch.float32 if name in _F32_LEAVES else cfg.torch_dtype
    if name.startswith("norm") or name in ("gate_norm", "final_norm"):
        return torch.ones(full, dtype=dt, device=device)
    if name in ("conv_b", "dt_bias") or name.startswith("b"):
        return torch.zeros(full, dtype=dt, device=device)
    if name == "A_log":
        return torch.zeros(full, dtype=dt, device=device)  # A = -exp(0) = -1
    if name == "D":
        return torch.ones(full, dtype=dt, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return dense_init(g, full, dt, fan_in, device)


def _init_tree(g, device, tree, cfg: ArchConfig, stacked: int = 0):
    return {
        name: _init_tree(g, device, sub, cfg, stacked)
        if isinstance(sub, dict)
        else _init_leaf(g, device, name, sub, cfg, stacked)
        for name, sub in tree.items()
    }


def init_params(
    cfg: ArchConfig, generator: Optional[torch.Generator] = None, device=None
) -> Dict:
    """The reference's parameter tree, drawn on the generator's device, or
    else on ``device`` (the card by default) from a generator seeded 0; the
    meta device gives shapes without allocating.  Torch and JAX streams
    differ, so values never match the reference's."""
    if generator is not None:
        device = generator.device
    else:
        device = resolve_device(device)
        if device.type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
    dt = cfg.torch_dtype
    params: Dict = {}
    if cfg.frontend != "frame":  # audio encoders take embeddings directly
        params["embed"] = dense_init(generator, (cfg.vocab, cfg.d_model), dt, cfg.d_model, device)
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, (cfg.d_model, cfg.vocab), dt, cfg.d_model, device)
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
    params["stack"] = {
        f"pos{i}": _init_tree(generator, device, _position_shapes(cfg, i), cfg, cfg.n_periods)
        for i in range(len(cfg.period))
    }
    return params


def param_shapes(cfg: ArchConfig) -> Dict:
    """The parameter tree as meta tensors — shapes and dtypes, no allocation."""
    return init_params(cfg, device="meta")


class Block(nn.Module):
    """One period position: ``norm1`` + ``mixer`` (+ ``norm2`` + ``mlp``)."""

    def __init__(self, tree: Dict, trainable: bool = False):
        super().__init__()
        param = functools.partial(nn.Parameter, requires_grad=trainable)
        self.norm1 = param(tree["norm1"])
        self.mixer = nn.ParameterDict({k: param(t) for k, t in tree["mixer"].items()})
        if "mlp" in tree:
            self.norm2 = param(tree["norm2"])
            self.mlp = nn.ParameterDict({k: param(t) for k, t in tree["mlp"].items()})


class DecoderLM(nn.Module):
    """The model of every family, the audio encoder included: ``embed``
    (None for a frame config), ``layers`` (per period repetition, an
    ``nn.ModuleDict`` of ``pos{i}`` blocks), ``final_norm`` and ``head``.
    Built from a reference-layout tree whose leaves are checked against
    ``param_shapes(cfg)``.  Serving needs no gradients, so every parameter
    is frozen unless ``trainable``; each per-period parameter is a view of
    its stacked leaf, so training updates the tree in place."""

    def __init__(self, cfg: ArchConfig, tree: Dict, trainable: bool = False):
        super().__init__()
        _check_tree(tree, param_shapes(cfg))
        self.cfg = cfg
        param = functools.partial(nn.Parameter, requires_grad=trainable)
        self.embed = param(tree["embed"]) if "embed" in tree else None
        if not cfg.tie_embeddings:
            self.head = param(tree["head"])
        self.final_norm = param(tree["final_norm"])
        self.layers = nn.ModuleList(
            nn.ModuleDict({pos: Block(_take(sub, p), trainable) for pos, sub in tree["stack"].items()})
            for p in range(cfg.n_periods)
        )

    @classmethod
    def from_config(
        cls, cfg: ArchConfig, seed: int = 0, device=None, trainable: bool = False
    ) -> "DecoderLM":
        """Random weights drawn on ``device`` (the card unless the caller
        asks for the CPU) from a seeded ``torch.Generator``."""
        device = resolve_device(device)
        g = torch.Generator(device=device).manual_seed(seed)
        return cls(cfg, init_params(cfg, g), trainable)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def cache_periods(self, caches: Dict):
        """Each period's slice of the stacked decode caches: views, so the
        decode step's in-place writes land in ``caches``."""
        for p in range(len(self.layers)):
            yield {pos: {name: t[p] for name, t in sub.items()} for pos, sub in caches.items()}

    # What the steps, the optimizer and the checkpoint ask of a model; a
    # ``distributed.sharding.ShardedLM`` answers the same for its shards.
    def view(self, sum_axes=()) -> "DecoderLM":
        """What the model code reads: the model itself."""
        return self

    def grad_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of ``grads`` (by parameter name)."""
        return global_norm(grads.values())

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf laid out like parameter ``name``: ``t`` itself."""
        return t

    def slices(self, name: str):
        """The index of parameter ``name`` this model holds: all of it."""
        return ...


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, taken in f32, as the
    reference writes it.  (``torch.linalg.vector_norm`` in f32 sums naively
    on the CPU: 1.6e-3 relative error over 3e7 elements.)"""
    return torch.stack([torch.square(g.float()).sum() for g in grads]).sum().sqrt()


def _take(tree: Dict, p: int) -> Dict:
    """Period ``p``'s slice of a stacked subtree (views, no copy)."""
    return {k: _take(v, p) if isinstance(v, dict) else v[p] for k, v in tree.items()}


def _check_tree(tree: Dict, spec: Dict, path: str = "") -> None:
    if set(tree) != set(spec):
        raise ValueError(f"parameter tree at {path or '/'}: keys {sorted(tree)}, want {sorted(spec)}")
    for k, want in spec.items():
        got, where = tree[k], f"{path}/{k}"
        if isinstance(want, dict):
            _check_tree(got, want, where)
        elif got.shape != want.shape or got.dtype != want.dtype:
            raise ValueError(
                f"parameter {where}: {tuple(got.shape)} {got.dtype}, "
                f"want {tuple(want.shape)} {want.dtype}"
            )


# ---------------------------------------------------------------------------
# Embeddings and the period body
# ---------------------------------------------------------------------------
def embed_tokens(table: torch.Tensor, tokens: torch.Tensor, cfg: ArchConfig,
                 ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """The token embedding lookup: ``table[tokens]``, or, where the
    vocabulary splits over ``ctx``'s model axis, the lookup on this rank's
    rows summed over the group (``parallel.vocab_embed``); times
    ``cfg.embedding_multiplier`` in the embedding's dtype."""
    vctx = vocab_ctx(cfg, ctx)
    x = table[tokens] if vctx is None else vocab_embed(table, tokens, cfg, vctx)
    return x if cfg.embedding_multiplier == 1 else x * cfg.embedding_multiplier


def embed_inputs(params: DecoderLM, cfg: ArchConfig, batch: Dict,
                 ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """(B, S, d) initial hidden states from the modality frontend.

    * text:   token embedding lookup (``embed_tokens``: vocab-parallel under
              ``ctx`` where the vocabulary splits)
    * vlm:    token embedding; the first ``n_frontend_tokens`` positions are
              replaced by ``batch["patch_embeds"]`` (B, P, d) in the
              embedding's dtype.  Out of place (``torch.cat``), so autograd
              sees the replacement: the replaced positions give ``embed`` no
              gradient, as in the reference's ``dynamic_update_slice``.
              Under a split vocabulary the replacement comes after the
              lookups are summed, on the whole embedding.
    * audio:  ``batch["frame_embeds"]`` in the model dtype is the input
    """
    if cfg.frontend == "frame":
        return batch["frame_embeds"].to(cfg.torch_dtype)
    x = embed_tokens(params.embed, batch["tokens"], cfg, ctx)  # (B, S, d)
    if cfg.frontend == "patch":
        patches = batch["patch_embeds"].to(x.dtype)  # (B, P, d)
        if patches.shape[1] > x.shape[1]:
            raise ValueError(f"{patches.shape[1]} patch embeddings for {x.shape[1]} positions")
        x = torch.cat([patches, x[:, patches.shape[1] :]], dim=1)
    return x


def _residual(x: torch.Tensor, y: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """``x + y``, the sub-layer's output ``y`` times ``cfg.residual_multiplier``
    first (in the model dtype) where that is not 1."""
    m = cfg.residual_multiplier
    return x + y if m == 1 else x + y * m


def _channel_mix(
    blk: Block, x: torch.Tensor, cfg: ArchConfig, kind: str, ctx: Optional[MeshContext]
) -> torch.Tensor:
    h = rms_norm(x, blk.norm2, cfg.norm_eps)
    if kind == "moe":
        return _residual(x, moe_block(blk.mlp, h, cfg, ctx), cfg)
    return _residual(x, mlp_block(blk.mlp, h, cfg, ctx), cfg)


def _period_forward(
    period: nn.ModuleDict,
    x: torch.Tensor,
    cfg: ArchConfig,
    ctx: Optional[MeshContext],
    positions: torch.Tensor,
    collect_cache: bool,
    inner_remat: bool = False,
    first_layer: int = 0,
):
    """One period over a full sequence (train / prefill).  Returns (x,
    caches) where caches[f"pos{i}"] holds the decode carry when
    ``collect_cache``: for attention dict(k, v), the roped K/V that
    ``attention_block`` made (the reference recomputes them; in f32 the two
    are equal); for SSM dict(state, conv).

    ``inner_remat`` additionally checkpoints every sublayer (the mixer and
    the channel mix), as the reference's "sublayer" policy does.  Each
    checkpointed call gets its block as an argument, never through a
    closure: the backward recomputes it after the loop has moved on.

    Each mixer with its norm and residual is a ``model.mixer`` span, each
    channel mix a ``model.mlp`` span (``obs/spans.py``), ``layer`` counted
    from ``first_layer``, the index of the period's first layer."""

    def ck(f, *args):
        return checkpointed(f, *args) if inner_remat else f(*args)

    caches = {}
    for i, (mixer, mlp) in enumerate(zip(cfg.period, cfg.mlp_pattern)):
        blk = period[f"pos{i}"]
        with span("model.mixer", layer=first_layer + i, mixer=mixer):
            h = rms_norm(x, blk.norm1, cfg.norm_eps)
            if mixer == "attn":
                attn = functools.partial(attention_block, positions=positions, ctx=ctx, full_kv=collect_cache)
                y, (k, v) = ck(attn, blk.mixer, h, cfg)
                carry = {"k": k, "v": v}
            else:
                y, (state, conv) = ck(functools.partial(ssm_block, ctx=ctx), blk.mixer, h, cfg)
                carry = {"state": state, "conv": conv}
            x = _residual(x, y, cfg)
        if collect_cache:
            caches[f"pos{i}"] = carry
        if mlp != "none":
            with span("model.mlp", layer=first_layer + i):
                x = ck(_channel_mix, blk, x, cfg, mlp, ctx)
    return x, caches


def _period_decode(
    period: nn.ModuleDict,
    cslice: Dict,
    x: torch.Tensor,
    cfg: ArchConfig,
    ctx: Optional[MeshContext],
    cache_pos: int,
    kv_len: torch.Tensor,
) -> torch.Tensor:
    """One period for one new token.  Writes into ``cslice`` in place (the
    reference returns updated copies): an attention position's K/V at
    ``cache_pos``, an SSM position's new state and conv tail over the old."""
    # made on the device: a host-to-device copy would wait for the queue
    positions = torch.arange(cache_pos, cache_pos + 1, device=x.device)
    for i, (mixer, mlp) in enumerate(zip(cfg.period, cfg.mlp_pattern)):
        blk = period[f"pos{i}"]
        c = cslice[f"pos{i}"]
        h = rms_norm(x, blk.norm1, cfg.norm_eps)
        if mixer == "attn":
            y, _ = attention_block(
                blk.mixer, h, cfg, positions=positions,
                kv_cache=(c["k"], c["v"]), cache_pos=cache_pos, kv_len=kv_len, ctx=ctx,
            )
        else:
            y, (state, conv) = ssm_block_decode(blk.mixer, h, cfg, (c["state"], c["conv"]), ctx)
            c["state"].copy_(state)
            c["conv"].copy_(conv)
        x = _residual(x, y, cfg)
        if mlp != "none":
            x = _channel_mix(blk, x, cfg, mlp, ctx)
    return x


# ---------------------------------------------------------------------------
# Full forward passes
# ---------------------------------------------------------------------------
# The projections' products are the matmuls with no batch dims: the port of
# jax.checkpoint_policies.dots_with_no_batch_dims_saveable.  The attention
# and SSD einsums run as batched products (bmm) and are recomputed.
_SAVEABLE_DOTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.mm.dtype))


def _save_dots(ctx, op, *args, **kwargs):
    if op in _SAVEABLE_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def forward(
    params: DecoderLM,
    cfg: ArchConfig,
    batch: Dict,
    ctx: Optional[MeshContext] = None,
    *,
    remat: bool = True,
    collect_cache: bool = False,
    remat_policy: Optional[str] = "minimal",
):
    """Embeddings -> period stack -> final norm.

    Returns (hidden (B,S,d), caches) — caches stacked over periods when
    ``collect_cache`` (prefill), else None.

    ``remat`` checkpoints each period while autograd records (the reference
    checkpoints its scan body).  ``remat_policy``: "minimal" saves only the
    period carries (full recompute in backward); "dots" additionally saves
    the projections' outputs (selective checkpointing); "sublayer" nests a
    checkpoint around every sublayer.
    """
    x = embed_inputs(params, cfg, batch, ctx)
    positions = torch.arange(x.shape[1], device=x.device)
    inner = remat and remat_policy == "sublayer"
    kw = {}
    if remat and remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    per_period = []
    for p, period in enumerate(params.layers):
        args = (period, x, cfg, ctx, positions, collect_cache, inner, p * len(cfg.period))
        x, caches = checkpointed(_period_forward, *args, **kw) if remat else _period_forward(*args)
        per_period.append(caches)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    if not collect_cache:
        return x, None
    stacked = {
        pos: {name: torch.stack([c[pos][name] for c in per_period]) for name in sub}
        for pos, sub in per_period[0].items()
    }
    return x, stacked


def _head_weight(params: DecoderLM, cfg: ArchConfig) -> torch.Tensor:
    """(d, V) — or this rank's (d, V/m) under a split vocabulary."""
    return params.embed.T if cfg.tie_embeddings else params.head


def head_logits(hidden: torch.Tensor, w: torch.Tensor, cfg: ArchConfig,
                ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """The head product, f32: ``hidden @ w`` on every column of ``w``, which
    under a split vocabulary are this rank's V/m; the hidden state then
    enters the group's region (its gradient is the sum of the ranks'
    partial products).  Divided by ``cfg.logits_scaling`` where that is
    not 1."""
    vctx = vocab_ctx(cfg, ctx)
    if vctx is not None:
        vocab_range(cfg, vctx, w.shape[1], "the head")
        hidden = into_region(hidden, vctx)
    logits = _dot_f32(hidden, w)
    return logits if cfg.logits_scaling == 1 else logits / cfg.logits_scaling


def lm_head(params: DecoderLM, cfg: ArchConfig, hidden: torch.Tensor,
            ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """f32 logits: over the whole vocabulary, or this rank's V/m columns
    where it splits over ``ctx``'s model axis (``parallel.vocab_gather``
    joins them)."""
    return head_logits(hidden, _head_weight(params, cfg), cfg, ctx)


def _ce_chunk(w: torch.Tensor, h_c: torch.Tensor, l_c: torch.Tensor, cfg: ArchConfig,
              ctx: Optional[MeshContext]):
    """Summed masked cross entropy of one chunk, and its count of labels;
    vocab-parallel where the vocabulary splits over ``ctx``."""
    logits = head_logits(h_c, w, cfg, ctx)  # f32 (B, c, V) or (B, c, V/m)
    vctx = vocab_ctx(cfg, ctx)
    if vctx is None:
        lse = torch.logsumexp(logits, dim=-1)  # (B, c)
        gold = torch.gather(logits, -1, l_c.clamp_min(0)[..., None]).squeeze(-1)
        nll = lse - gold
    else:
        nll = vocab_parallel_nll(logits, l_c, cfg, vctx)
    mask = (l_c >= 0).float()
    return (nll * mask).sum(), mask.sum()


def _counted(S: int, chunk: int) -> int:
    """How many leading positions ``chunked_ce_loss`` counts: whole chunks."""
    chunk = min(chunk, S)
    return (S // chunk) * chunk


def label_count(labels: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """The f32 count of labels >= 0 that ``chunked_ce_loss`` divides by."""
    return (labels[:, : _counted(labels.shape[1], chunk)] >= 0).sum(dtype=torch.float32)


def chunked_ce_loss(
    params: DecoderLM,
    cfg: ArchConfig,
    hidden: torch.Tensor,
    labels: torch.Tensor,
    *,
    chunk: int = 512,
    count: Optional[torch.Tensor] = None,
    ctx: Optional[MeshContext] = None,
) -> torch.Tensor:
    """Cross entropy over sequence chunks, each checkpointed, so the (B, S, V)
    logits tensor never exists for more than ``chunk`` positions at a time.

    labels < 0 are masked out.  As in the reference, only the first
    ``(S // chunk) * chunk`` positions count: the tail past the last whole
    chunk is dropped.  The masked sum is divided by ``count`` where given
    (sharded training: the ``label_count`` of the global batch, of which
    ``labels`` are this rank's rows), else by this batch's own.  Under
    ``ctx`` with a split vocabulary each chunk's product and CE run on this
    rank's V/m columns (``parallel.vocab_parallel_nll``), still one
    checkpoint a chunk.
    """
    S = hidden.shape[1]
    w = _head_weight(params, cfg)
    ce = functools.partial(_ce_chunk, cfg=cfg, ctx=ctx)
    chunk = min(chunk, S)
    labels = labels.long()
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        t, n = checkpointed(ce, w, hidden[:, sl], labels[:, sl])
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp_min(cnt if count is None else count, 1.0)


def train_loss(
    params: DecoderLM,
    cfg: ArchConfig,
    batch: Dict,
    remat_policy: Optional[str] = "minimal",
    ctx: Optional[MeshContext] = None,
    count: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The training loss: ``forward`` with remat, then ``chunked_ce_loss``
    (divided by ``count`` where given).

    Training never reaches a hand kernel: the reference trains without its
    Pallas kernels (``use_pallas`` defaults to False and they have no
    backward), so this takes the chunked attention and chunked SSD whatever
    ``cfg.use_kernels`` says.
    """
    cfg = dataclasses.replace(cfg, use_kernels=False)
    hidden, _ = forward(params, cfg, batch, ctx, remat=True, remat_policy=remat_policy)
    return chunked_ce_loss(params, cfg, hidden, batch["labels"], count=count, ctx=ctx)


# ---------------------------------------------------------------------------
# Serving: prefill + one-token decode
# ---------------------------------------------------------------------------
def prefill(params: DecoderLM, cfg: ArchConfig, batch: Dict, ctx: Optional[MeshContext] = None):
    """Process the prompt; returns (last-position logits f32 (B, V), state)
    — (B, V/m), this rank's columns, under a split vocabulary.

    state = (caches stacked over periods, kv_len (B,) int32).
    """
    hidden, caches = forward(params, cfg, batch, ctx, remat=False, collect_cache=True)
    logits = lm_head(params, cfg, hidden[:, -1:], ctx)[:, 0]
    B, S = hidden.shape[0], hidden.shape[1]
    kv_len = torch.full((B,), S, dtype=torch.int32, device=hidden.device)
    return logits, (caches, kv_len)


def init_decode_state(
    cfg: ArchConfig, batch: int, max_len: int, device=None
) -> Tuple[Dict, torch.Tensor]:
    """Empty decode state sized for a ``max_len`` context.  Every cache is
    a tensor of its own (K and V too): decode writes into them in place."""
    device = resolve_device(device)
    caches = {}
    for i, mixer in enumerate(cfg.period):
        if mixer == "attn":
            shape = (cfg.n_periods, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            caches[f"pos{i}"] = {
                "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            }
        else:
            st, conv = ssm_empty_carry(cfg, batch, device)
            caches[f"pos{i}"] = {
                "state": torch.stack([st] * cfg.n_periods),
                "conv": torch.stack([conv] * cfg.n_periods),
            }
    kv_len = torch.zeros((batch,), dtype=torch.int32, device=device)
    return caches, kv_len


def decode_step(
    params: DecoderLM,
    cfg: ArchConfig,
    tokens: torch.Tensor,  # (B, 1) integer ids
    state: Tuple[Dict, torch.Tensor],
    cache_pos: int,  # slot the new token occupies
    ctx: Optional[MeshContext] = None,
):
    """One serving step: consume one token, emit next-token logits.

    Returns (logits f32 (B, V), new_state); the logits are this rank's
    (B, V/m) under a split vocabulary.  The caches in ``state`` are updated
    in place and returned in ``new_state``; kv_len is a new tensor.
    """
    caches, kv_len = state
    cache_pos = int(cache_pos)
    x = embed_tokens(params.embed, tokens, cfg, ctx)  # (B, 1, d)
    new_kv_len = torch.clamp_min(kv_len, cache_pos + 1)
    # cache_periods goes first: zip asks it once more at the end, which lets a
    # ShardedLM's take the last period's writes back before it stops
    for cslice, period in zip(params.cache_periods(caches), params.layers):
        x = _period_decode(period, cslice, x, cfg, ctx, cache_pos, new_kv_len)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = lm_head(params, cfg, x, ctx)[:, 0]
    return logits, (caches, new_kv_len)
