"""What each gloo rank of chip_smoke.py's phase 16 runs on the card.

Not a script: ``chip_smoke.py`` spawns the ranks with
``repro_torch.launch.ranks.spawn_ranks(chip_train_ranks.run, 4,
args=(conf,))`` after building the kernels, and every rank imports this
module by name.  Each rank runs on ``cuda:0`` (one card shared by the
ranks' processes, which talk over gloo) and returns plain numbers; a
failed check raises.  ``tests/test_torch_train_ranks.py`` holds the same
code paths to the reference on the CPU; ``conf["device"] = "cpu"`` runs
this module there at a small ``conf``.

(a) training, at each (data, model) rank layout of ``conf["layouts"]``
    ((2, 2) and (1, 4)): ``launch.train.build`` over the group at
    ``--model-par`` the layout's model ranks, one peer a rank: each rank
    keeps its blocks of granite-moe-1b-a400m at full size and takes
    ``conf["steps"][layout]`` steps of ``conf["batch"]`` x
    ``conf["seq"]``, each timed with the card synchronised; its loss
    and norm bits, its top-k launches a step, the bytes it delivered to
    other ranks a step by axis beside the count reckoned from the specs
    and the config (:func:`predicted_by_axis`,
    :func:`model_axis_events`), the
    parameter bytes the step gathered beside the data-only reckoning
    (each leaf's model block whole over the data axes), its
    ``max_memory_allocated``, and a digest of each block (the replicas
    of a leaf must agree bit for bit);
(b) at each layout, the same arch at full width and
    ``conf["xcheck_layers"]`` layers in f32 with TF32 off: one step over
    the ranks (the (2, 2) state then checkpointed to ``conf["ckpt"]``);
    rank 0 takes the same step on one process over a mesh of virtual
    peers of the same shape (the same data shards, so the same MoE
    capacity) and measures the relative error of the loss and of the
    gradient's norm (AdamW's update does not see the gradient's scale,
    so the norm is what holds the reduce's sum over data ranks) and each
    parameter's relative L2 error after the update;
(c) ``serve decode`` (``launch.serve.decode_run``) over the group for
    each (arch, layout) of ``conf["decode"]``: at (2, 2) in the
    config's dtype and in f32 with TF32 off, at (1, 4) in f32; then
    each arch of ``conf["decode_wide"]`` over (1, 4) in f32 at full
    width and the depth its changes give: its tokens, seconds, launches
    and delivered bytes, its caches' bytes against the layout
    (:func:`cache_layout`) and one more decode step's bytes by axis
    against :func:`model_axis_events`; in the config's dtype, and for MoE
    at (1, 4) in f32 with its routers' choices, also this rank's blocks
    of the logits it samples from (:func:`decode_logits`).
"""
import dataclasses
import math
import time

import torch
import torch.distributed as dist


def _require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def digest(t) -> int:
    """A 64-bit digest of a tensor's bits (position-weighted, wrapping
    int64 sums) for any element size."""
    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[t.element_size()]
    b = t.detach().contiguous().view(bits).reshape(-1).to(torch.int64)
    w = torch.arange(b.numel(), device=t.device, dtype=torch.int64)
    return int(((b + 0x9E3779B9) * (w * 2 + 1)).sum())


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def predicted_by_axis(params, specs, mesh, microbatches=1) -> dict:
    """The bytes this rank delivers to other ranks in one train step over
    each mesh axis, from the specs alone, apart from the model axis's
    activations (:func:`model_axis_bytes`): each leaf gathered over the
    data axes (each rank-spanning axis of each dim in turn: the piece
    held so far, to every other rank of the axis); each gradient (f32
    under microbatches, else the parameter's dtype; a model block whole
    over the data axes) reduced over ``pod`` then ``data``, a
    reduce-scatter ((n - 1) / n of it) where the spec cuts it over the
    axis, else a reduce-scatter and an all-gather of its zero-padded
    chunks; the labelled-token counts and the loss gathered over each
    data axis in turn, and the norm's partial sum over every rank
    axis."""
    from repro_torch.optim import sharding as S
    out = {a: 0 for a in mesh.axis_names}
    data_axes = S.rank_axes(mesh, S.FSDP_AXES)
    for name, p in params.named_parameters():
        spec = specs[name]
        piece = p.numel() * p.element_size()
        whole = p.numel()
        for entry in spec:
            for a in reversed(S._names(entry)):
                if a in S.FSDP_AXES and a in mesh.shape \
                        and mesh.axis(a).ranks > 1:
                    r = mesh.axis(a).ranks
                    out[a] += piece * (r - 1)
                    piece *= r
                    whole *= r
        size = 4 if microbatches > 1 else p.element_size()
        named = {a for entry in spec for a in S._names(entry)}
        cur = whole
        for ax in data_axes:
            n = ax.ranks
            if ax.name in named:
                out[ax.name] += cur * size * (n - 1) // n
                cur //= n
            else:
                out[ax.name] += 2 * -(-cur // n) * (n - 1) * size
    for ax in data_axes:
        out[ax.name] += 4 * microbatches * (ax.ranks - 1) \
            + 4 * (ax.ranks - 1)
    for ax in S.rank_axes(mesh, mesh.axis_names):
        out[ax.name] += 4 * (ax.ranks - 1)
    return out


def model_axis_events(cfg, mode, rows, seq, msize, ranks,
                      microbatches=1, remat="none") -> list:
    """The model-axis collectives of one step's products, reckoned from
    the config and the partition rules (``optim/sharding.py``'s
    predicates), as ``(kind, elements, itemsize)``: ``"all-reduce"`` a
    sum in rank order (or a maximum) of a tensor every model rank holds
    (``core/mesh.py::all_reduce``), ``"all-gather"`` the concatenation
    of a block of that many elements, ``"reduce-scatter"`` a sum in
    rank order of which each rank keeps its block
    (``core/mesh.py::reduce_scatter``).  ``mode``: ``"train"`` (forward
    and backward of ``loss_fn`` on each microbatch of ``rows`` /
    ``microbatches`` rows), ``"decode"`` (one token; ``seq`` is S_max)
    or ``"prefill"``; ``msize`` model peers over ``ranks`` model ranks.
    Empty over one rank.

    In decode, an attention cache whose sequence dim (S_max, a window's
    min(W, S_max) slots, the encoder's frames) divides ``msize`` holds
    each rank's block of it (``optim/sharding.py::cache_seq_block``),
    and its attention adds (``models/attention.py``): where the query
    heads split, the all-gather of the rank's query heads; where the KV
    heads split, the all-gather of the new token's k and v (one block of
    both); the scores' maximum and the sum of their exponentials
    (``(B, H)``, f32, f64 in f64); the product with V summed, a
    reduce-scatter over the heads where the query heads split, else an
    all-reduce (MLA: the context ``(B, H, kv_lora_rank)``).

    Under ``remat`` ``"full"`` or ``"dots"`` the backward recomputes
    each group of ``len(cfg.mixer_pattern)`` decoder layers
    (``models/transformer.py::stack_apply``; the remainder layers, the
    encoder, the lookup and the loss are not wrapped), and the recompute
    replays the group's forward collectives in their order up to the
    last one whose output a backward reads: torch's checkpoint stops
    recomputing once every saved tensor is back, so the sum that closes
    the group's last FFN (``apply_ffn``'s, which only a residual add
    reads) is not replayed, while a sum that a later product or norm
    reads is."""
    from repro_torch.models.model import DTYPES
    from repro_torch.optim import sharding as S
    if ranks == 1:
        return []
    m = msize
    e = DTYPES[cfg.param_dtype].itemsize
    d, hd = cfg.d_model, cfg.resolved_head_dim
    train = mode == "train"
    b = rows // microbatches if train else rows
    s = 1 if mode == "decode" else seq
    ev = []
    fwd = []           # the forward events of the layer being reckoned
    tail = [False]     # whether fwd ends with an FFN's closing sum

    def ar(n, size=e, back=False, closing=False):
        if not back or train:
            ev.append(("all-reduce", n, size))
        if not back:
            fwd.append(("all-reduce", n, size))
            tail[0] = closing

    def ag(n, back=False):
        ev.append(("all-gather", n, e))
        if not back:
            fwd.append(("all-gather", n, e))
            tail[0] = False

    def split(kind, name, n):
        return S.splits_over_model(kind, name, cfg, m, n)

    def rs(n, size):
        ev.append(("reduce-scatter", n, size))

    def seq_attn(t, n_ctx, cross=False):
        """The decode's reductions over a cache of ``n_ctx`` positions
        cut over the model ranks."""
        if mode != "decode" or n_ctx % m:
            return
        wide = max(e, 4)
        hq = cfg.n_heads
        if cfg.attn_kind == "mla":
            for n in (t * hq, t * hq, t * hq * cfg.mla.kv_lora_rank):
                ar(n, wide)
            return
        heads = S.heads_split(cfg, m)
        if heads:
            ag(t * hq // ranks * hd)                  # q
        if not cross and S.kv_split(cfg, m):
            ag(2 * t * cfg.n_kv_heads // ranks * hd)  # the new k and v
        ar(t * hq, wide)                              # the maximum
        ar(t * hq, wide)                              # the sum of exp
        if heads:
            rs(t * hq * hd, wide)                     # p @ v, its heads
        else:
            ar(t * hq * hd, wide)

    def attn(t, src=None):
        if not S.heads_split(cfg, m):
            return
        ar(t * d)                                  # w_o's sum
        ar(t * d, back=True)                       # copy_to_model(x)
        if src is not None:
            ar(src * d, back=True)                 # copy_to_model(enc)
        if not S.kv_split(cfg, m):
            n_kv = cfg.n_kv_heads * hd
            for _ in ("w_k", "w_v"):
                ar(d * n_kv, back=True)
            if cfg.qkv_bias:
                for _ in ("b_k", "b_v"):
                    ar(n_kv, back=True)

    def ffn(t):
        if cfg.moe is not None:
            mo = cfg.moe
            if split("moe", "w_up", mo.n_experts):
                cap = math.ceil(t * mo.top_k / mo.n_experts
                                * mo.capacity_factor)
                block = mo.n_experts // ranks * cap * d
                ag(block)                                   # ye
                if train:
                    ag(block, back=True)                    # buf
            fs = mo.d_expert * mo.n_shared_experts
            if fs and split("ffn", "w_up", fs):
                ar(t * d, closing=True)
                ar(t * d, back=True)
            return
        if split("ffn", "w_k" if cfg.act == "rwkv_channel_mix"
                 else "w_up", cfg.d_ff):
            # the channel mix's r * v reads its sum
            ar(t * d, closing=cfg.act != "rwkv_channel_mix")
            ar(t * d, back=True)

    def mixer(kind, t):
        if kind == "attn":
            seq_attn(t, min(cfg.local_window, seq) if cfg.local_window
                     else seq)
        if kind == "attn" and cfg.attn_kind != "mla":
            attn(t)
        elif kind == "rglru" and split("rglru", "w_x",
                                       cfg.recurrent.lru_width or d):
            ar(t * d)
            ar(t * d, back=True)

    kinds = cfg.layer_kinds()
    glen = len(cfg.mixer_pattern)
    grouped = (len(kinds) // glen * glen
               if train and remat in ("full", "dots") else 0)
    for _ in range(microbatches if train else 1):
        t = b * s
        vocab = split("top", "embed", cfg.padded_vocab())
        n_vis = min(256, seq) if cfg.mrope_sections is not None \
            and mode != "decode" else 0
        if vocab and n_vis < s:
            ar(t * d)                              # the lookup's sum
        if cfg.is_encoder_decoder and mode != "decode":
            for _ in range(cfg.n_encoder_layers):
                attn(b * cfg.encoder_seq)
                ffn(b * cfg.encoder_seq)
        for i, kind in enumerate(kinds):
            if i % glen == 0:
                fwd.clear()
                tail[0] = False
            mixer(kind, t)
            if cfg.is_encoder_decoder:
                if mode == "decode":
                    seq_attn(t, cfg.encoder_seq, cross=True)
                    if S.heads_split(cfg, m):
                        ar(t * d)
                else:
                    attn(t, b * cfg.encoder_seq)
            ffn(t)
            if i < grouped and i % glen == glen - 1:
                ev.extend(fwd[:-1] if tail[0] else fwd)    # the recompute
        if vocab and train:
            ar(t * d, back=True)                   # copy_to_model(h)
            wide = max(e, 4)
            for _ in ("max", "sumexp", "picked"):
                ar(t, wide)
    return ev


def model_axis_bytes(events, ranks) -> dict:
    """From :func:`model_axis_events` over ``ranks`` model ranks: the
    bytes this rank delivers (``"sent"``) and the collectives' operand
    bytes by kind as ``roofline/trace.py`` counts them (an all-reduce is
    a reduce-scatter of the zero-padded tensor and an all-gather of its
    chunk)."""
    n = ranks
    sent, ops = 0, {"reduce-scatter": 0, "all-gather": 0}
    for kind, numel, size in events:
        if kind == "all-reduce":
            chunk = -(-numel // n)
            sent += 2 * chunk * (n - 1) * size
            ops["reduce-scatter"] += chunk * n * size
            ops["all-gather"] += chunk * size
        elif kind == "reduce-scatter":
            sent += numel * size * (n - 1) // n
            ops["reduce-scatter"] += numel * size
        else:
            sent += numel * (n - 1) * size
            ops["all-gather"] += numel * size
    return {"sent": sent, "operands": ops}


def predicted_bytes(params, specs, mesh, microbatches=1, cfg=None,
                    rows=None, seq=None, remat="none") -> int:
    """The bytes this rank delivers to other ranks in one train step:
    :func:`predicted_by_axis` over every axis, plus, given the config
    and this rank's ``rows`` x ``seq`` batch, the model axis's
    activations under ``remat`` (:func:`model_axis_bytes`)."""
    total = sum(predicted_by_axis(params, specs, mesh,
                                  microbatches).values())
    if cfg is not None:
        ax = mesh.axis("model")
        total += model_axis_bytes(model_axis_events(
            cfg, "train", rows, seq, ax.size, ax.ranks, microbatches,
            remat), ax.ranks)["sent"]
    return total


def _train(rank, conf, dev, layout):
    from repro_torch.data.pipeline import device_put_batch
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.optim import sharding as S
    group = dist.group.WORLD
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg, mesh, params, opt, step_fn, data = train.build(
        conf["arch"], smoke=conf.get("smoke", False), batch=conf["batch"],
        seq=conf["seq"], model_par=layout[1], microbatches=1, remat="none",
        lr=3e-4, steps=conf["steps"][layout], device=dev, group=group)
    _sync(dev)
    build_s = time.perf_counter() - t0
    _require(tuple(mesh.shape.values()) == layout
             and tuple(mesh.ranks.values()) == layout,
             f"rank {rank}: mesh {mesh}, want {layout}")
    specs = step_fn.specs
    by_axis = predicted_by_axis(params, specs, mesh)
    ax = mesh.axis("model")
    rows = conf["batch"] // layout[0]
    acts = model_axis_bytes(model_axis_events(
        cfg, "train", rows, conf["seq"], ax.size, ax.ranks), ax.ranks)
    predicted = {a: by_axis[a] + (acts["sent"] if a == "model" else 0)
                 for a in by_axis}
    # the parameters a step holds gathered: each leaf's model block,
    # whole over the data axes (the data-only reckoning), against the
    # whole parameters
    reckoned_gather = sum(
        math.prod(S.global_shape(p.shape, tuple(
            e if any(a in S.FSDP_AXES for a in S._names(e)) else None
            for e in specs[n]), mesh)) * p.element_size()
        for n, p in params.named_parameters())
    whole_bytes = sum(math.prod(S.global_shape(p.shape, specs[n], mesh))
                      * p.element_size()
                      for n, p in params.named_parameters())
    gathered = [0]
    plain_gather = S.gather_leaf

    def counting_gather(block, spec, mesh_, axes=None):
        out = plain_gather(block, spec, mesh_, axes=axes)
        gathered[0] += out.numel() * out.element_size()
        return out
    losses, norms, step_s, sent, launches, got_gather = ([], [], [], [], [],
                                                         [])
    S.gather_leaf = counting_gather
    try:
        for i in range(conf["steps"][layout]):
            batch = device_put_batch(data.batch_at(i), mesh)
            _sync(dev)
            dist.barrier()
            _build.reset_launches()
            before = dict(mesh.sent_by_axis)
            gathered[0] = 0
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch)
            _sync(dev)
            step_s.append(time.perf_counter() - t0)
            sent.append({a: mesh.sent_by_axis[a] - before[a]
                         for a in before})
            got_gather.append(gathered[0])
            launches.append(dict(_build.LAUNCHES))
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
    finally:
        S.gather_leaf = plain_gather
    trace = None
    if conf.get("trace") and layout == (2, 2):
        # one more step traced (phase 17's fake trace of it is the peer)
        from repro_torch.roofline.trace import analyze
        totals = analyze(step_fn, params, opt,
                         device_put_batch(data.batch_at(0), mesh),
                         device=dev.type)
        trace = {"flops": totals.flops,
                 "bytes_accessed": totals.bytes_accessed,
                 "kernels": totals.kernels,
                 "coll_by_axis": totals.coll_by_axis}
    want = {"topk": cfg.n_layers, "topk_select": 0, "merge": 0}
    for i, got in enumerate(launches):
        got = {k: got[k] for k in want}
        _require(dev.type != "cuda" or got == want,
                 f"rank {rank} step {i}: launches {got}, want {want}")
    _require(all(math.isfinite(x) for x in losses + norms),
             f"rank {rank}: losses {losses}, norms {norms}")
    out = {"losses": losses, "grad_norms": norms, "step_s": step_s,
           "sent_bytes": sent, "predicted_bytes": predicted,
           "model_axis_operands": acts["operands"],
           "gathered_bytes": got_gather,
           "reckoned_gather_bytes": reckoned_gather,
           "whole_param_bytes": whole_bytes,
           "launches": launches, "build_s": build_s,
           "coord": (mesh.axis("data").index, mesh.axis("model").index),
           "digests": {n: digest(p) for n, p in params.named_parameters()},
           "specs": specs, "n_layers": cfg.n_layers, "trace": trace}
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return out


def _f32(conf):
    """The arch at full width and ``conf["xcheck_layers"]`` layers in
    f32."""
    from repro_torch.configs.base import get_config, smoke_config
    base = get_config(conf["arch"])
    if conf.get("smoke"):
        base = smoke_config(base)
    return dataclasses.replace(base, n_layers=conf["xcheck_layers"],
                               param_dtype="float32",
                               compute_dtype="float32")


def _xcheck(rank, conf, dev, layout):
    """(b): the f32 step over the ranks at ``layout`` against one
    process; the (2, 2) state is checkpointed."""
    from repro_torch.ckpt.checkpoint import save
    from repro_torch.core.mesh import Mesh
    from repro_torch.data.pipeline import SyntheticLM, device_put_batch
    from repro_torch.launch.train import place_blocks
    from repro_torch.models import model as M
    from repro_torch.optim import sharding as S
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.runtime.steps import make_train_step
    cfg = _f32(conf)
    ocfg = AdamWConfig(lr=3e-4, total_steps=2, warmup_steps=1)
    raw = SyntheticLM(cfg.vocab_size, conf["seq"], conf["batch"],
                      seed=4).batch_at(0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        mesh = Mesh(layout, ("data", "model"), dev,
                    group=dist.group.WORLD, ranks=layout)

        def model():
            return M.init_params(torch.Generator(dev).manual_seed(0), cfg,
                                 max_seq=conf["seq"], device=dev)

        params = model()
        specs = place_blocks(params, cfg, mesh)
        opt = adamw_init(params, ocfg)
        step = make_train_step(cfg, ocfg, remat="none", mesh=mesh,
                               specs=specs)
        params, opt, m = step(params, opt, device_put_batch(raw, mesh))
        loss, norm = m["loss"].item(), m["grad_norm"].item()
        whole = {n: S.gather_leaf(p.detach(), specs[n], mesh)
                 for n, p in params.named_parameters()}
        out = {"loss": loss, "grad_norm": norm}
        if layout == (2, 2):
            save(conf["ckpt"], 1, (params, opt), mesh=mesh, specs=specs)
            out["saved"] = {
                "params": {n: digest(t) for n, t in whole.items()},
                "m": {n: digest(S.gather_leaf(t, specs[n], mesh))
                      for n, t in opt.m.items()},
                "v": {n: digest(S.gather_leaf(t, specs[n], mesh))
                      for n, t in opt.v.items()}}
        del params, opt
        dist.barrier()
        if rank == 0:
            one = model()
            vmesh = Mesh(layout, ("data", "model"), dev)
            step1 = make_train_step(cfg, ocfg, remat="none", mesh=vmesh)
            one, _, m1 = step1(one, adamw_init(one, ocfg),
                               device_put_batch(raw, dev))
            l1, n1 = m1["loss"].item(), m1["grad_norm"].item()
            rel = {}
            for n, p in one.named_parameters():
                ref = p.detach().double()
                rel[n] = float((whole[n].double() - ref).norm()
                               / ref.norm().clamp_min(1e-30))
            out.update(one_loss=l1, loss_rel=abs(loss - l1) / abs(l1),
                       one_grad_norm=n1,
                       grad_norm_rel=abs(norm - n1) / abs(n1),
                       param_rel=rel)
        dist.barrier()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def restore_onto(rank, world, conf):
    """The f32 checkpoint of (b) restored onto this group's (world, 1)
    mesh; digests of the whole leaves."""
    from repro_torch.ckpt.checkpoint import restore
    from repro_torch.core.mesh import Mesh
    from repro_torch.launch.train import place_blocks
    from repro_torch.models import model as M
    from repro_torch.optim import sharding as S
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    dev = _device(conf)
    cfg = _f32(conf)
    mesh = Mesh((world, 1), ("data", "model"), dev,
                group=dist.group.WORLD, ranks=(world, 1))
    params = M.init_params(torch.Generator(dev).manual_seed(1), cfg,
                           max_seq=conf["seq"], device=dev)
    specs = place_blocks(params, cfg, mesh)
    params, opt = restore(conf["ckpt"], 1, (params, adamw_init(
        params, AdamWConfig())), device=dev, mesh=mesh, specs=specs)
    return {"params": {n: digest(S.gather_leaf(p.detach(), specs[n], mesh))
                       for n, p in params.named_parameters()},
            "m": {n: digest(S.gather_leaf(t, specs[n], mesh))
                  for n, t in opt.m.items()},
            "v": {n: digest(S.gather_leaf(t, specs[n], mesh))
                  for n, t in opt.v.items()},
            "step": int(opt.step)}


def decode_state_layout(state, cfg, mesh, *, s_max: int):
    """The specs of the port's decode state, to check its caches by:
    ``optim/sharding.py::decode_state_specs``' (the reference's rule),
    but for a window cache's ``pos_slots``, which takes the entry of its
    own ``k``'s window dim, so that a rank holds the positions of the
    slots it holds.  The reference's spec gives a stacked window cache's
    ``pos_slots`` the batch axes (reference fault 10), which place no
    slot by its ``k``.  The program's own rule is
    ``optim/sharding.py::cache_seq_block``; where the spec cuts no
    sequence dim, a rank holds its heads of the cache
    (``models/attention.py``), which no spec names."""
    from repro_torch.models.attention import WindowKVCache
    from repro_torch.optim.sharding import decode_state_specs
    specs = decode_state_specs(state, cfg, mesh, s_max=s_max)
    caches = state.caches if hasattr(state, "caches") else state
    out = specs.caches if hasattr(specs, "caches") else specs
    fixed = []
    for c, sp in zip(caches, out):
        sp = dict(sp)
        if isinstance(c.get("self"), WindowKVCache):
            sp["self"] = sp["self"]._replace(
                pos_slots=(sp["self"].k[1],))
        fixed.append(sp)
    if hasattr(specs, "caches"):
        return specs._replace(caches=fixed)
    return fixed


def _attn_leaves(caches, keys, specs=None):
    """(tensor, spec) of every leaf of the attention caches of ``keys``
    ("self", "cross") of a decode state's caches (``specs``: a spec
    structure alike)."""
    out = []
    for i, layer in enumerate(caches):
        for key in keys:
            if key in layer:
                sp = specs[i][key] if specs is not None else layer[key]
                out += list(zip(layer[key], sp))
    return out


def cache_layout(cfg, mesh, state, batch, s_max) -> dict:
    """The caches the state cuts over the model ranks (``"split"``)
    against those the rule cuts (``"want_split"``: each whole length
    that divides the model size, the model axis spanning ranks), and
    this rank's bytes of the caches the rule cuts (``"bytes"``) against
    the bytes of :func:`decode_state_layout`'s block of
    the whole batch's f32 state (``"layout_bytes"``).  (A cache it does
    not cut holds the rank's KV heads, which no spec names.)"""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.optim import sharding as S
    whole = M.init_decode_state(cfg, batch=batch, s_max=s_max,
                                cache_dtype=torch.float32, device="meta")
    specs = decode_state_layout(whole, cfg, mesh, s_max=s_max)

    def block(t, spec):
        return t.element_size() * math.prod(
            n // math.prod(mesh.axis(a).ranks for a in S._names(e)
                           if a in mesh.shape)
            for n, e in zip(t.shape, tuple(spec) + (None,) * t.dim()))
    with L.use_mesh(mesh):
        want = T.seq_split(cfg, s_max)
    return {"bytes": sum(t.numel() * t.element_size()
                         for t, _ in _attn_leaves(state.caches, want)),
            "layout_bytes": sum(block(t, sp) for t, sp in _attn_leaves(
                whole.caches, want, specs.caches)),
            "split": dict(state.seq_split), "want_split": want}


def _step_bytes(cfg, mesh, params, state, rows, s_max, dev):
    """The bytes one more decode step (``model.decode_step`` of this
    rank's ``rows``, no sampling) delivers by axis, beside
    :func:`model_axis_events`' reckoning of the model axis."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    tok = torch.zeros((rows, 1), dtype=torch.int32, device=dev)
    before = dict(mesh.sent_by_axis)
    with L.use_mesh(mesh):
        M.decode_step(params, cfg, state, tok)
    _sync(dev)
    ax = mesh.axis("model")
    return {"sent": {a: mesh.sent_by_axis[a] - before[a] for a in before},
            "reckoned_model": model_axis_bytes(model_axis_events(
                cfg, "decode", rows, s_max, ax.size, ax.ranks),
                ax.ranks)["sent"]}


def _decode(rank, argv, dev, dtype=None, changes=None):
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import _decode_args, decode_run
    _sync(dev)
    dist.barrier()
    _build.reset_launches()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = dtype is None and tf32
    try:
        out = decode_run(argv, group=dist.group.WORLD, dtype=dtype,
                         changes=changes)
        _sync(dev)
        launches = dict(_build.LAUNCHES)
        args = _decode_args(argv)
        s_max = args.prompt_len + args.gen
        mesh, state = out["mesh"], out["state"]
        layout = cache_layout(out["cfg"], mesh, state, args.batch, s_max)
        sent = dict(mesh.sent_by_axis)
        step = _step_bytes(out["cfg"], mesh, out["params"], state,
                           args.batch // mesh.ranks["data"], s_max, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"tokens": out["tokens"], "t_prefill": out["t_prefill"],
            "t_decode": out["t_decode"],
            "sent_bytes": sum(sent.values()), "sent_by_axis": sent,
            "launches": launches, "layout": layout, "step": step}


class record_routes:
    """Records every MoE router's choice while it is entered (nothing
    when ``on`` is false): ``self.log`` gets, a router call at a time,
    the (T, E) probabilities the top-k reads (numpy f64) and the (T, k)
    expert ids it picked.  With ``replay`` (another run's log of the
    same calls) the router takes that run's experts, gated by its own
    probabilities, in place of its own choice, which the log still
    records."""

    def __init__(self, on=True, replay=None):
        self.on, self.log, self.replay = on, [], replay

    def __enter__(self):
        if self.on:
            from repro_torch.models import moe
            self._orig = moe.topk_with_grad

            def rec(probs, k):
                vals, ids = self._orig(probs, k)
                self.log.append((probs.detach().double().cpu().numpy(),
                                 ids.cpu().numpy()))
                if self.replay is not None:
                    ids = torch.as_tensor(self.replay[len(self.log) - 1][1],
                                          dtype=ids.dtype, device=ids.device)
                    vals = probs.gather(-1, ids.long()).to(vals.dtype)
                return vals, ids
            moe.topk_with_grad = rec
        return self

    def __exit__(self, *exc):
        if self.on:
            from repro_torch.models import moe
            moe.topk_with_grad = self._orig


def route_flips(a, b):
    """Two runs' router logs (:class:`record_routes`, the same calls on
    the same tokens): the (call, token) pairs whose expert sets differ."""
    return [(c, t) for c, ((_, ia), (_, ib)) in enumerate(zip(a, b))
            for t in range(ia.shape[0])
            if set(ia[t].tolist()) != set(ib[t].tolist())]


def route_margins(log):
    """Each (call, token)'s margin in a router log: the gap between the
    k-th and the (k+1)-th largest probability, over the k-th (so a
    relative gap; 0 is a tie), k the experts it picks.  A list of (T,)
    arrays, a call each."""
    import numpy as np
    out = []
    for probs, ids in log:
        k = ids.shape[-1]
        top = -np.sort(-probs, axis=-1)
        out.append((top[:, k - 1] - top[:, k]) / top[:, k - 1])
    return out


def decode_logits(argv, dev, group=None, blocks=1, dtype=None,
                  routes=False, replay=None):
    """The logits ``serve decode`` of ``argv`` computes before it
    samples, in the config's dtype (or ``dtype``; TF32 off for f32), on
    ``decode_run``'s weights and prompt: the prompt's last logits and
    the first step's logits (the step fed the prompt's first token, so
    every side feeds the same one).  Over a group, this rank's rows and
    vocabulary block on its model blocks; else, without ``group``, the
    whole batch and vocabulary on the whole weights, ``blocks`` data
    blocks of rows one at a time (MoE dispatches per data shard, as
    over the data ranks), in that dtype and, as ``"wide"``, on the same
    weights in the next wider dtype (f32 with TF32 off for bf16, f64
    for ``f32``).  With ``routes``, ``"routes"`` holds each block's router
    log (:class:`record_routes`) of the prefill and the step; with
    ``replay`` (such logs, a block each) the routers take the logged
    experts.  Numpy f32."""
    import numpy as np
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import _decode_args, state_from_prefill
    from repro_torch.launch.train import place_blocks
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.optim import sharding as S
    args = _decode_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=dtype,
                                  compute_dtype=dtype)
    s_max = args.prompt_len + args.gen
    params = M.init_params(torch.Generator(dev).manual_seed(0), cfg,
                           max_seq=s_max, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32))
    mesh, rows = None, torch.arange(args.batch)
    if group is not None:
        mesh = make_host_mesh(model=args.model_par, device=dev, cfg=cfg,
                              group=group, model_ranks=args.model_ranks)
        place_blocks(params, cfg, mesh, axes=("model",))
        rows = S.shard_leaf(rows, ("data",), mesh)

    def logits(params, cfg):
        out = {"last": [], "first": []}
        logs = []
        for i, part in enumerate(rows.chunk(blocks)):
            batch = {"tokens": tokens[part].to(dev)}
            with L.use_mesh(mesh), record_routes(
                    routes, None if replay is None else replay[i]) as rec:
                last, pst = M.prefill(params, cfg, batch)
                state = state_from_prefill(cfg, pst, s_max)
                first, _ = M.decode_step(params, cfg, state,
                                         batch["tokens"][:, :1])
            logs.append(rec.log)
            out["last"].append(last.float().cpu().numpy())
            out["first"].append(first[:, 0].float().cpu().numpy())
        out = {k: np.concatenate(v) for k, v in out.items()}
        if routes:
            out["routes"] = logs
        return out

    tf32 = torch.backends.cuda.matmul.allow_tf32
    if dtype == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = logits(params, cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["rows"] = rows.numpy()
    if mesh is not None:
        out["model_index"] = mesh.axis("model").index
        out["data_index"] = mesh.axis("data").index
        return out
    wide = "float64" if cfg.compute_dtype == "float32" else "float32"
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out["wide"] = logits(params.to(getattr(torch, wide)),
                             dataclasses.replace(cfg, param_dtype=wide,
                                                 compute_dtype=wide))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def _moe(argv):
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import _decode_args
    return get_config(_decode_args(argv).arch).moe is not None


def _device(conf):
    dev = torch.device(conf.get("device", "cuda"))
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        from repro_torch.kernels import _build
        _build.ensure_built()
    else:
        torch.set_num_threads(1)
    return dev


def _free(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run(rank: int, world: int, conf: dict) -> dict:
    """Phase 16 on this rank: (a) and (b) at each layout of
    ``conf["layouts"]``, then (c)."""
    dev = _device(conf)
    t0 = time.perf_counter()
    out = {"train": {}, "xcheck": {}, "decode": {}, "decode_f32": {},
           "seconds_by_part": {}}
    took = out["seconds_by_part"]
    for lay in conf["layouts"]:
        t1 = time.perf_counter()
        out["train"][lay] = _train(rank, conf, dev, lay)
        if out["train"][lay]["trace"] is not None:
            out["trace"] = out["train"][lay]["trace"]
        _free(dev)
        took[f"train {lay}"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        out["xcheck"][lay] = _xcheck(rank, conf, dev, lay)
        _free(dev)
        took[f"f32 check {lay}"] = time.perf_counter() - t1
    for (arch, lay), argv in conf["decode"].items():
        t1 = time.perf_counter()
        if lay == (2, 2):
            out["decode"][arch] = _decode(rank, argv, dev)
            _free(dev)
            out["decode"][arch]["logits"] = decode_logits(
                argv, dev, group=dist.group.WORLD)
            _free(dev)
        out["decode_f32"][(arch, lay)] = _decode(rank, argv, dev, "float32")
        _free(dev)
        if lay == (1, 4) and _moe(argv):
            out["decode_f32"][(arch, lay)]["logits"] = decode_logits(
                argv, dev, group=dist.group.WORLD, dtype="float32",
                routes=True)
            _free(dev)
        took[f"decode {arch} {lay}"] = time.perf_counter() - t1
    for arch, (argv, changes) in conf.get("decode_wide", {}).items():
        t1 = time.perf_counter()
        out["decode_f32"][(arch, "wide")] = _decode(rank, argv, dev,
                                                    "float32", changes)
        _free(dev)
        took[f"decode {arch} wide"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return out
