"""The cases of the multi-process port tests, and the functions their ranks
run (through ``repro_torch.distributed.ranks.run_ranks``).

Imported by the test modules, by the rank processes and by the JAX
subprocess (``_jax_sharded_reference.py``), so it imports neither torch nor
JAX at module level: inputs are numpy arrays drawn from seeds, and each side
builds its own config with ``case_cfg``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

PHI, DBRX, JAMBA = "phi3.5-moe-42b-a6.6b", "dbrx-132b", "jamba-1.5-large-398b"
DANUBE, HUBERT, VLM = "h2o-danube-3-4b", "hubert-xlarge", "phi-3-vision-4.2b"

# ---------------------------------------------------------------------------
# The sharded MoE block: reduced phi3.5-moe and dbrx (4 experts, top-2), x of
# 4 x 16 tokens, at a capacity factor of 1.0, which drops tokens at both
# mesh shapes (the tests check that it does).
# ---------------------------------------------------------------------------
BLOCK_ARCHS = [PHI, DBRX]
BLOCK_DTYPES = ["float32", "bfloat16"]
BLOCK_MESHES = [(1, 2), (2, 2)]
BLOCK_B, BLOCK_S = 4, 16
BLOCK_CAPACITY = 1.0
TABLE_ARCHS = [PHI, JAMBA]  # the parameter tables held on (2, 2)


# reduced danube with grouped kv heads, named "<arch>@<H>x<KV>": on a model
# axis of 2, 2 kv heads split with the query heads (4x2); 1 kv head is
# gathered and each rank takes its columns, the gradient summed over model
# (4x1); 3 query heads split unevenly, 2 on rank 0 and 1 on rank 1, with
# every attention leaf gathered whole and summed over model (3x1); and 6
# heads over 3 kv heads split 3 a rank, each rank's 3 crossing a kv-group
# boundary of 2, so its core runs on two runs of heads, 2 + 1 on rank 0 and
# 1 + 2 on rank 1 (6x3; its leaves gathered as 3x1's)
DANUBE_KV2, DANUBE_KV1, DANUBE_H3 = f"{DANUBE}@4x2", f"{DANUBE}@4x1", f"{DANUBE}@3x1"
DANUBE_H6 = f"{DANUBE}@6x3"
# reduced danube at a vocabulary the model axis of 2 does not divide, named
# "<arch>@v<V>": embed and head stay whole on every rank (the reduced
# configs' 512 split into 256 rows a rank)
DANUBE_V511 = f"{DANUBE}@v511"


def case_cfg(configs, arch: str, dtype: str = "float32", **kw):
    """The reduced config of ``arch`` from either package's ``configs``;
    ``<arch>@<H>x<KV>`` sets its query and kv heads, ``<arch>@v<V>`` its
    vocabulary."""
    arch, _, variant = arch.partition("@")
    if variant.startswith("v"):
        kw["vocab"] = int(variant[1:])
    elif variant:
        kw["n_heads"], kw["n_kv_heads"] = map(int, variant.split("x"))
    return dataclasses.replace(configs.reduce_for_smoke(configs.get(arch)), dtype=dtype, **kw)


def block_key(arch: str, dtype: str, mesh) -> str:
    return f"{arch}|{dtype}|{mesh[0]}x{mesh[1]}"


def block_inputs(cfg, seed: int = 0):
    """numpy params (N(0, 1/fan_in)), x (B, S, d) and a cotangent for y."""
    rng = np.random.default_rng(seed)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    shapes = {"router": (d, E), "w_gate": (E, d, f), "w_down": (E, f, d)}
    if cfg.mlp_act == "swiglu":
        shapes["w_up"] = (E, d, f)
    params = {k: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32) for k, s in shapes.items()}
    x = rng.standard_normal((BLOCK_B, BLOCK_S, d)).astype(np.float32)
    g = rng.standard_normal((BLOCK_B, BLOCK_S, d)).astype(np.float32)
    return params, x, g


def _mesh_and_rules(n_data: int, n_model: int):
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.mesh import make_smoke_mesh

    mesh = make_smoke_mesh(n_data, n_model, device_type="cpu")
    return mesh, ShardingRules(mesh, fsdp_axes=("data",))


def sharded_block_rank(rank: int, world: int, n_data: int, n_model: int):
    """Every block case on an (n_data, n_model) mesh of CPU ranks: this
    rank's y (its batch slice), in f32 its gradients (x's slice, the router,
    its experts) of sum(y * g), and at a data axis of 1 the local path's y
    on the same rank; on (2, 2), also the parameter tables: ``local_slices``
    of every leaf and whether torch's ``distribute_tensor`` with
    ``placements`` holds exactly that slice."""
    import torch

    from repro_torch import configs
    from repro_torch.distributed.sharding import (
        batch_spec, local_part, local_slices, param_shardings, placements,
    )
    from repro_torch.launch.mesh import mesh_sizes
    from repro_torch.models.model import param_shapes
    from repro_torch.models.moe import moe_block
    from repro_torch.models.parallel import MeshContext

    mesh, rules = _mesh_and_rules(n_data, n_model)
    ctx = MeshContext(mesh, batch_axes=("data",))
    n_local = None
    out = {}
    for arch in BLOCK_ARCHS:
        for dtype in BLOCK_DTYPES:
            cfg = case_cfg(configs, arch, dtype, capacity_factor=BLOCK_CAPACITY)
            n_local = cfg.n_experts // n_model
            e0 = ctx.model_rank * n_local
            key = block_key(arch, dtype, (n_data, n_model))
            params, x, g = block_inputs(cfg)
            dt = getattr(torch, dtype)
            full = {k: torch.from_numpy(v).to(dt) for k, v in params.items()}
            local = {k: (v if k == "router" else v[e0:e0 + n_local]).clone() for k, v in full.items()}
            xs = local_part(torch.from_numpy(x).to(dt), batch_spec(rules, BLOCK_B, 2), mesh).clone()
            gs = local_part(torch.from_numpy(g), batch_spec(rules, BLOCK_B, 2), mesh)
            grads = dtype == "float32"
            for t in (*local.values(), xs):
                t.requires_grad_(grads)
            y = moe_block(local, xs, cfg, ctx)
            out[f"{key}|y"] = y.detach().float().numpy()
            if grads:
                (y.float() * gs).sum().backward()
                out[f"{key}|grad_x"] = xs.grad.numpy()
                for k, t in local.items():
                    out[f"{key}|grad_{k}"] = t.grad.numpy()
                if n_data == 1:
                    with torch.no_grad():
                        out[f"{key}|local_y"] = moe_block(full, xs, cfg).numpy()
    out["e0"] = np.array(ctx.model_rank * n_local)
    out["coord"] = np.array(mesh.get_coordinate())
    if (n_data, n_model) == (2, 2):
        from torch.distributed.tensor import distribute_tensor

        for arch in TABLE_ARCHS:
            cfg = case_cfg(configs, arch)
            specs = param_shardings(rules, cfg, param_shapes(cfg))
            for path, spec, leaf in _leaves(specs, param_shapes(cfg)):
                shape = tuple(leaf.shape)
                sl = local_slices(spec, shape, mesh_sizes(mesh), mesh.get_coordinate())
                t = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
                held = distribute_tensor(t, mesh, placements(spec, mesh)).to_local()
                out[f"table|{arch}|{path}"] = np.array([(s.start, s.stop) for s in sl])
                out[f"dtensor|{arch}|{path}"] = np.array(torch.equal(held, t[sl]))
    return out


def device_rank(rank: int, world: int):
    """The card this rank was put on (-1: none, the ranks run on the CPU)."""
    import torch

    on_card = torch.cuda.is_available() and torch.cuda.is_initialized()
    return {"card": np.array(torch.cuda.current_device() if on_card else -1)}


def _leaves(specs, shapes, prefix=""):
    for k, v in shapes.items():
        if isinstance(v, dict):
            yield from _leaves(specs[k], v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", specs[k], v


# ---------------------------------------------------------------------------
# The rules-aware serving steps on (data 2, model 2): reduced configs in f32,
# weights from DecoderLM.from_config's seed.  The MoE configs take a
# capacity factor of 4.0, at which no token is dropped: the single-process
# run computes the capacity of the global batch, each data shard that of
# its own tokens, so only without drops do the two compute the same
# function.
# ---------------------------------------------------------------------------
SERVE_CASES = [(PHI, 2), (PHI, 1), (DANUBE, 2), (JAMBA, 2),  # (arch, global batch)
               (DANUBE_KV2, 2), (DANUBE_KV1, 2), (DANUBE_H3, 2), (DANUBE_H6, 2), (DANUBE_KV2, 1),
               (DANUBE_V511, 2)]
SERVE_S, SERVE_NEW, NO_DROP_CAPACITY = 16, 4, 4.0
ENCODE_B, ENCODE_S = 2, 16
SEED = 3


def serve_cfg(configs, arch: str):
    kw = {"capacity_factor": NO_DROP_CAPACITY} if configs.get(arch.partition("@")[0]).n_experts else {}
    return case_cfg(configs, arch, **kw)


class LayerWidths:
    """While in use, records the widths the layers compute on: the query
    heads each attention core sees (the flash entry point, the chunked and
    the plain attention), and the heads of each core call of one attention
    block in order, joined by "+" (``attn_runs``: "2+1" for a block whose
    core ran on 2 heads, then 1), the heads of each SSD scan (the scan entry
    point and the chunked scan), the hidden width of each dense MLP (its
    ``w_down`` rows), the columns of each head product (``head_logits``: the
    serving logits and each CE chunk) and the rows of each embedding table
    looked up (``embed_tokens``)."""

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.models import layers, model, ssm

        self.seen = {"attn_heads": set(), "attn_runs": set(), "ssd_heads": set(), "mlp_hidden": set(),
                     "head_cols": set(), "embed_rows": set()}
        self._saved, self._blocks = [], []

        def spy(mod, name, kind, width):
            orig = getattr(mod, name)

            def wrapped(*a, **k):
                self.seen[kind].add(width(*a))
                return orig(*a, **k)

            self._saved.append((mod, name, orig))
            setattr(mod, name, wrapped)

        def heads(t, *a):
            if self._blocks:
                self._blocks[-1].append(t.shape[2])
            return t.shape[2]

        def block(params, x, *a, **k):
            self._blocks.append([])
            try:
                return orig_block(params, x, *a, **k)
            finally:
                self.seen["attn_runs"].add("+".join(map(str, self._blocks.pop())))

        orig_block = model.attention_block
        self._saved.append((model, "attention_block", orig_block))
        model.attention_block = block
        for mod, name in ((ops, "flash_attention"), (layers, "plain_attention"), (layers, "chunked_attention")):
            spy(mod, name, "attn_heads", heads)
        for mod, name in ((ops, "ssd_scan"), (ssm, "ssd_chunked")):
            spy(mod, name, "ssd_heads", heads)
        spy(model, "mlp_block", "mlp_hidden", lambda params, *a: params["w_down"].shape[0])
        spy(model, "head_logits", "head_cols", lambda hidden, w, *a: w.shape[1])
        spy(model, "embed_tokens", "embed_rows", lambda table, *a: table.shape[0])
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self._saved:
            setattr(mod, name, orig)

    def put(self, out: dict, key: str) -> None:
        for kind, widths in self.seen.items():
            out[f"{key}|seen|{kind}"] = np.array(sorted(widths), dtype=str if kind == "attn_runs" else np.int64)


def no_redistribution() -> None:
    """DTensor's ``redistribute`` made to raise in this rank: every step
    must move data by c10d collectives alone (DTensor's all-gather killed a
    gloo rank on CUDA tensors)."""
    from torch.distributed.tensor import DTensor

    def refuse(self, *a, **k):
        raise AssertionError("a rules-aware step reached DTensor.redistribute")

    DTensor.redistribute = refuse


def serve_prompt(cfg, B: int) -> np.ndarray:
    return np.random.default_rng(B).integers(0, cfg.vocab, (B, SERVE_S)).astype(np.int64)


def encode_frames(cfg) -> np.ndarray:
    return np.random.default_rng(5).standard_normal((ENCODE_B, ENCODE_S, cfg.d_model)).astype(np.float32)


def patch_prompt(cfg) -> dict:
    """A VLM prompt of ``ENCODE_B`` x ``ENCODE_S`` tokens whose first
    ``n_frontend_tokens`` positions are patch embeddings."""
    rng = np.random.default_rng(6)
    return {"tokens": rng.integers(0, cfg.vocab, (ENCODE_B, ENCODE_S)).astype(np.int64),
            "patch_embeds": rng.standard_normal((ENCODE_B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)}


def greedy(prefill, decode, model, prompt, n_new: int, full, grow):
    """Prefill, ``grow`` the state's K/V caches by ``n_new`` slots, then
    ``n_new`` greedy decode steps; ``full`` turns a step's logits into the
    global (B, V) logits.  Returns (tokens (B, n_new), the logits of every
    step, the state)."""
    import torch

    logits, state = prefill(model, {"tokens": prompt})
    state = grow(state, n_new)
    toks, seen = [], []
    for step in range(n_new):
        logits = full(logits)
        seen.append(logits)
        tok = torch.argmax(logits, -1)[:, None]
        toks.append(tok)
        if step + 1 < n_new:
            logits, state = decode(model, state, tok, prompt.shape[1] + step)
    return torch.cat(toks, 1), torch.stack(seen), state


def steps_rank(rank: int, world: int):
    """Every serving case through the rules-aware steps on (2, 2): greedy
    tokens and logits (gathered to the global batch), each decode cache
    shard's shape against ``state_shardings``; hubert's encoder logits; and
    the logits of a patch prompt's prefill (phi-3-vision: the patches go
    over the summed vocab-parallel lookup); the loss of one
    ``make_train_step`` with the rules (phi3.5-moe, batch 2); for each, the
    widths its layers computed on (``LayerWidths``).
    DTensor's ``redistribute`` raises in this rank throughout."""
    import torch

    from repro_torch import configs
    from repro_torch.distributed.sharding import (
        ShardedLM, batch_spec, from_local, gather, local_slices, placements, shard_state,
        state_shardings,
    )
    from repro_torch.launch.mesh import mesh_sizes
    from repro_torch.launch.steps import make_decode_step, make_encoder_step, make_prefill_step
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import DecoderLM, init_decode_state
    from repro_torch.serving.engine import grow_kv
    from repro_torch.training.optimizer import OptSettings, adamw_init

    no_redistribution()
    mesh, rules = _mesh_and_rules(2, 2)
    out = {"coord": np.array(mesh.get_coordinate())}

    def rows(t, B):
        """The global (B, ...) tensor of which ``t`` is this rank's rows."""
        spec = batch_spec(rules, B, t.ndim - 1)
        return gather(from_local(t.contiguous(), mesh, placements(spec, mesh), (B, *t.shape[1:])))

    for arch, global_b in SERVE_CASES:
        cfg = serve_cfg(configs, arch)
        model = ShardedLM(DecoderLM.from_config(cfg, seed=SEED, device="cpu"), rules)
        prompt = torch.from_numpy(serve_prompt(cfg, global_b))
        prefill = make_prefill_step(cfg, rules, global_b)
        decode = make_decode_step(cfg, rules, global_b)
        def layout(key, caches, kv_len, B, S, cfg):
            """Whether each shard of a decode state has the shape
            ``state_shardings`` gives this rank, and its whole the global
            shape."""
            want, kv_spec = state_shardings(rules, cfg, init_decode_state(cfg, B, S, device="meta"))
            coord = mesh.get_coordinate()
            for pos, sub in caches.items():
                for name, dt in sub.items():
                    sl = local_slices(want[pos][name], dt.shape, mesh_sizes(mesh), coord)
                    out[f"{key}|{pos}/{name}"] = np.array(
                        [tuple(dt.to_local().shape) == tuple(s.stop - s.start for s in sl),
                         tuple(dt.shape) == (cfg.n_periods, B, *dt.shape[2:])])
            out[f"{key}|kv_len"] = np.array(
                [tuple(kv_len.to_local().shape) == tuple(
                    s.stop - s.start for s in local_slices(kv_spec, (B,), mesh_sizes(mesh), coord))])

        def grow(state, n, B=global_b, cfg=cfg, key=f"{arch}|{global_b}|layout|prefill"):
            """Gathered to this rank's rows, grown, laid out again; the
            prefill's own layout recorded first."""
            caches, kv_len = state
            layout(key, caches, kv_len, B, SERVE_S, cfg)
            held = {pos: {name: gather(t, keep_dims=(1,)) for name, t in sub.items()}
                    for pos, sub in caches.items()}
            return shard_state(rules, cfg, (grow_kv(held, n), kv_len.to_local()), B)

        key = f"{arch}|{global_b}"
        with LayerWidths() as widths:
            toks, logits, (caches, kv_len) = greedy(prefill, decode, model, prompt, SERVE_NEW,
                                                    lambda t, B=global_b: rows(t, B), grow)
        widths.put(out, key)
        out[f"{key}|tokens"] = toks.numpy()
        out[f"{key}|logits"] = logits.numpy()
        layout(f"{key}|layout", caches, kv_len, global_b, SERVE_S + SERVE_NEW, cfg)
    cfg = case_cfg(configs, HUBERT)
    model = ShardedLM(DecoderLM.from_config(cfg, seed=SEED, device="cpu"), rules)
    with LayerWidths() as widths:
        enc = make_encoder_step(cfg, rules, ENCODE_B)(model, {"frame_embeds": torch.from_numpy(encode_frames(cfg))})
    widths.put(out, HUBERT)
    out[f"{HUBERT}|logits"] = rows(enc, ENCODE_B).numpy()
    cfg = case_cfg(configs, VLM)
    model = ShardedLM(DecoderLM.from_config(cfg, seed=SEED, device="cpu"), rules)
    with LayerWidths() as widths:
        vlm, _ = make_prefill_step(cfg, rules, ENCODE_B)(
            model, {k: torch.from_numpy(v) for k, v in patch_prompt(cfg).items()})
    widths.put(out, VLM)
    out[f"{VLM}|logits"] = rows(vlm, ENCODE_B).numpy()
    cfg = serve_cfg(configs, PHI)
    model = ShardedLM(DecoderLM.from_config(cfg, seed=SEED, device="cpu"), rules, trainable=True)
    batch = {k: torch.from_numpy(v).long() for k, v in train_batch(cfg, 2).items()}
    with LayerWidths() as widths:
        loss, _, _ = make_train_step(cfg, OptSettings(), rules, 2)(model, adamw_init(model, OptSettings()), batch)
    widths.put(out, "train")
    out["train_loss"] = loss.numpy()
    try:
        from_local(torch.zeros(2), mesh, placements(("data",), mesh), (4,)).full_tensor()
        out["redistribute_refused"] = np.array(False)
    except AssertionError:
        out["redistribute_refused"] = np.array(True)
    return out


# ---------------------------------------------------------------------------
# Sharded training on (data 2, model 2): reduced danube, phi3.5-moe (at the
# capacity that drops no token) and mamba2 in f32, at a global batch of 4
# (split over data) and of 1 (which divides no data axis, so every rank
# takes the whole batch).  Weights from DecoderLM.from_config's seed.
# ---------------------------------------------------------------------------
MAMBA = "mamba2-130m"
TRAIN_ARCHS = [DANUBE, PHI, MAMBA, DANUBE_KV1, DANUBE_H3, DANUBE_H6, DANUBE_V511]
TRAIN_BATCHES = [4, 1]
TRAIN_S, TRAIN_STEPS = 32, 2
TRAIN_CLIP = 0.05  # under every case's gradient norm (the tests check), so the clip binds
TRAIN_MESH = (2, 2)
TRAIN_MESH_AXES = ("data", "model")
JOINT_SPEC = (("data", "model"), None)  # dim 0 split over both axes, data major


def joint_leaf() -> np.ndarray:
    return np.arange(8 * 3, dtype=np.float32).reshape(8, 3)


def train_key(arch: str, B: int, run: str = "default") -> str:
    return f"{arch}|{B}|{run}"


def train_batch(cfg, B: int) -> dict:
    """int32 tokens and labels (every label counts)."""
    rng = np.random.default_rng(100 + B)
    return {k: rng.integers(0, cfg.vocab, (B, TRAIN_S)).astype(np.int32) for k in ("tokens", "labels")}


# runs of one step at batch 4 besides the default: (run, microbatches, masked)
TRAIN_RUNS = {"clip": (1, False), "mb2": (2, False), "mask": (1, True), "mask_mb2": (2, True)}


def masked_train_batch(cfg) -> dict:
    """``train_batch(cfg, 4)`` with labels masked (-1) unevenly across the
    rows, so the two data ranks (rows 0-1 and 2-3) and the two microbatches
    hold different counts: 24 of row 0's 32 labels, every other one of
    row 1's, none of row 2's and the last 4 of row 3's."""
    batch = train_batch(cfg, 4)
    labels = batch["labels"]
    labels[0, :24] = -1
    labels[1, ::2] = -1
    labels[3, -4:] = -1
    return batch


def train_inputs(cfg, run: str) -> dict:
    """The batch of a batch-4 run."""
    return masked_train_batch(cfg) if TRAIN_RUNS.get(run, (1, False))[1] else train_batch(cfg, 4)


def train_settings(run: str, OptSettings):
    return OptSettings(grad_clip=TRAIN_CLIP) if run == "clip" else OptSettings()


def train_rank(rank: int, world: int, ckpt_in: str, ckpt_out: str):
    """Every sharded-training case on (2, 2): for each arch and global batch,
    the loss of each of ``TRAIN_STEPS`` steps and every shard after each; at
    batch 4 also one step of each of ``TRAIN_RUNS`` (a binding clip, 2
    microbatches, masked labels with 1 and 2 microbatches); each shard's
    reduced gradient of the default and masked runs and the global gradient
    norm; a leaf whose dim 0 is split over both axes, gathered, and its
    gradient under a cotangent of ``rank + 1`` times the leaf; the gradient
    of every leaf gathered whole and sliced over model, before its
    reduction (``gather_on_use`` is spied on), one forward and backward of
    the first step; a checkpoint of the trained shards written to
    ``ckpt_out/<arch>``, with the bytes of whole leaves alive on the device
    at once while it saves and the bytes each rank copies to the host; and
    the shards and moments restored from the single-process checkpoint in
    ``ckpt_in/<arch>``.  DTensor's ``redistribute`` raises in this rank
    throughout."""
    import weakref

    import torch

    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models.model import DecoderLM
    from repro_torch.training import checkpoint
    from repro_torch.training.optimizer import OptSettings, adamw_init

    no_redistribution()
    mesh, rules = _mesh_and_rules(*TRAIN_MESH)
    out = {"coord": np.array(mesh.get_coordinate())}

    def fresh(cfg):
        return sharding.ShardedLM(DecoderLM.from_config(cfg, seed=SEED, device="cpu"), rules, trainable=True)

    def put(key, model):
        for n, p in model.named_parameters():
            out[f"{key}|{n}"] = p.detach().numpy().copy()

    def tensors(batch):
        return {k: torch.from_numpy(v).long() for k, v in batch.items()}

    def save(arch, n_steps, model, opt):
        """``save_checkpoint``, watching the whole leaves it gathers (any
        output of ``_gathered`` that is not the shard itself) and the host
        copies it makes."""
        live, peak, hosted = [], [0], [0]
        gathered, host = sharding._gathered, checkpoint._host

        def watched(local, mesh_, layout):
            t = gathered(local, mesh_, layout)
            if t is not local:
                live.append(weakref.ref(t))
                live[:] = [r for r in live if r() is not None]
                peak[0] = max(peak[0], sum(r().numel() * r().element_size() for r in live))
            return t

        def hosting(t):
            a = host(t)
            hosted[0] += a.nbytes
            return a

        sharding._gathered, checkpoint._host = watched, hosting
        try:
            checkpoint.save_checkpoint(f"{ckpt_out}/{arch}", n_steps, model, opt)
        finally:
            sharding._gathered, checkpoint._host = gathered, host
        out[f"{arch}|saved|peak_whole_bytes"] = np.array(peak[0])
        out[f"{arch}|saved|host_bytes"] = np.array(hosted[0])

    # a dim split over both axes, as (pod, data) split one on the multi-pod
    # mesh: gathered whole, and its gradient summed over data only
    whole = torch.from_numpy(joint_leaf())
    spec = JOINT_SPEC
    layout = sharding._Layout(spec, tuple(sharding.placements(spec, mesh)), tuple(whole.shape),
                              whole.dtype, (), tuple(TRAIN_MESH_AXES))
    local = sharding.local_part(whole, spec, mesh).clone().requires_grad_(True)
    gathered = sharding.gather_on_use(local, mesh, layout, ("data",))
    (gathered * whole * (rank + 1)).sum().backward()
    out["joint|gathered"] = gathered.detach().numpy()
    out["joint|grad"] = local.grad.numpy()

    for arch in TRAIN_ARCHS:
        cfg = serve_cfg(configs, arch)
        for B in TRAIN_BATCHES:
            batch = tensors(train_batch(cfg, B))
            runs = [("default", TRAIN_STEPS, 1)]
            if B == 4:
                runs += [(run, 1, mb) for run, (mb, _) in TRAIN_RUNS.items()]
            for run, n_steps, mb in runs:
                settings = train_settings(run, OptSettings)
                model = fresh(cfg)
                opt = adamw_init(model, settings)
                step = make_train_step(cfg, settings, rules, B, microbatches=mb)
                inputs = batch if run == "default" else tensors(train_inputs(cfg, run))
                for s in range(n_steps):
                    loss, model, opt = step(model, opt, inputs)
                    out[f"{train_key(arch, B, run)}|loss{s}"] = loss.numpy()
                    put(f"{train_key(arch, B, run)}|step{s}", model)
                if run == "default" and B == 4:
                    save(arch, n_steps, model, opt)
                    for kind in ("m", "v"):
                        for n, t in opt[kind].items():
                            out[f"{arch}|saved|{kind}|{n}"] = t.numpy().copy()
                if run.startswith("mask"):
                    _, grads = loss_and_grads(fresh(cfg), cfg, inputs, microbatches=mb, rules=rules)
                    for n, g in grads.items():
                        out[f"{train_key(arch, B, run)}|grad|{n}"] = g.numpy()
            # the gradient before its reduction, and the global norm
            model = fresh(cfg)
            seen = {}
            plain = sharding.gather_on_use

            def spy(local, mesh_, layout, sum_axes):
                t = plain(local, mesh_, layout, sum_axes)
                if t.requires_grad and not layout.keep and not layout.summed_over:
                    t.retain_grad()
                    seen.setdefault(id(layout), t)  # the forward's, not a recompute's
                return t

            sharding.gather_on_use = spy
            try:
                _, grads = loss_and_grads(model, cfg, batch, rules=rules)
            finally:
                sharding.gather_on_use = plain
            layouts = {id(lay): n for n, lay in model._layout.items()}
            for lid, t in seen.items():
                out[f"{train_key(arch, B)}|gathered_grad|{layouts[lid]}"] = t.grad.numpy()
            out[f"{train_key(arch, B)}|grad_norm"] = model.grad_norm(grads).numpy()
            for n, g in grads.items():
                out[f"{train_key(arch, B)}|grad|{n}"] = g.numpy()
        model = fresh(cfg)
        opt = adamw_init(model, OptSettings())
        checkpoint.restore_checkpoint(f"{ckpt_in}/{arch}", like=(model, opt))
        put(f"{arch}|restored|params", model)
        for kind in ("m", "v"):
            for n, t in opt[kind].items():
                out[f"{arch}|restored|{kind}|{n}"] = t.numpy().copy()
        out[f"{arch}|restored|step"] = opt["step"].numpy()
    return out
