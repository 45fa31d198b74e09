#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths — the FD overlay top-k query served by a
``QueryServer``, statically and under churn with the CN / CN* baselines,
the ``DeviceEngine``'s FD collectives over 64 virtual peers, a
live overlay whose peers join and leave between queries, the serving
CLI and entry sharding, the LM decode with FD top-k sampling for
every registered arch, LM training with checkpoints, FD and the
compressed gradient mean across gloo ranks, and LM training and
serving across gloo ranks —
through the hand-written CUDA kernels, and fails (exit code 1, no
result line) when any phase fails:

  1. build the kernel library from ``src/repro_torch/kernels/csrc``;
  2. hold each kernel (merge, arrivals, wait and its churn variant,
     top-k) bit-equal to its plain PyTorch version on the card, in f64,
     f32 and bf16 (top-k: f32, bf16, f16), on inputs with ties, -inf
     tails, signed zeros and NaNs of both signs where the kernel orders
     scores; for the merge the library's launch plan equal to the
     wrapper's (``merge_plan``) and refusal of any other, its own plan
     and every route that can take the lists (bulk, direct, row) at k
     of 1 to 4096, at a tile's rows and one off and 70,001 rows, on views one row into a larger tensor, with
     masks, and f16 and int32 values through the promotion to f32, into
     outputs filled with NaN; and for the top-k the inputs that break
     selections by
     counting (ties at the k-th key across tiles, one repeated value,
     rows of the tile width and one off, n == k, specials at the
     threshold, all -inf), for the arrivals kernel the library's
     launch plan equal to the wrapper's (``arrivals_plan``) and refusal
     of any other, both its ways (gathered, staged) at the path's level
     shapes and the plan's edges (one row, one column, one parent, odd
     widths, dn off 16-byte alignment, 70,000 rows, int64 positions,
     repeated parents) with signed zeros, infinities and NaNs in
     tq_prev and dn; for both wait kernels the library's launch plan
     equal to the wrapper's (``wait_plan``) and refusal of any other,
     on each route, at the level shapes and odd sizes with 2% specials in
     every operand (death too), as views one element in (the scalar
     route) and on every quad of {+0, -0, 0.5, +inf, -inf, NaN}, and for
     the churn variant deaths exactly at the send time, infinite deaths
     and all-dead rows; for the top-k's select routes (k > 256) the
     library's plan equal to the wrapper's, also at the resident route's
     largest row and one either side, each launcher refusing the other
     route's plan, and k = 257, 512, 1,280 and 4096 and n == k on the
     inputs above on both routes, rows at that edge, long rows of one
     value and of ties at the k-th key across the long route's tiles
     (tolerance: exact — equal bits of values and owners; the
     arrivals and the waits write into outputs filled with NaN);
  3. serve 32 independent-stream ``fd-dynamic`` requests from 8 client
     threads plus one ``fd-basic``, ``fd-st1`` and ``fd-st1+2`` request
     on a 100,000-peer Barabási–Albert overlay (the reference package's
     full-size ``jax_backend`` configuration: m=2, seed 7,
     ``SimParams(seed=5)``), and check that every kernel of that path
     moved its launch counter; one ``fd-stats`` request at origin 0 in
     the same queue must be served from the host reference path
     (``backend_used == "sim"``), cut traffic and equal a direct
     ``engine.run``;
  3b. serve churn and the baselines from a second ``QueryServer`` over
     the same engine (the reference's full-size ``jax_churn_bench``
     settings: ``fd-dynamic``, independent streams, mean lifetimes of
     60 s and 600 s), 8 + 2 ``fd-dynamic`` requests from 4 client
     threads plus one ``fd-basic`` at 60 s, ``cn``, ``cn-star`` and
     ``cn`` at 60 s; check the answers, that peers died at lifetime 60,
     and that the wait kernel's churn variant, the merge and the
     arrivals moved their launch counters;
  4. run 4-entry specs (``fd-dynamic`` static and at lifetime 60,
     ``cn``, ``cn-star``) on the card and on the port's CPU path and
     require equal bits;
  5. drive the ``DeviceEngine`` on ``make_mesh((64,), ("model",))``, the
     paper's 64-node cluster: 32 queries of N = 64 x 20,000 scores
     (20,000 = ``SimParams.tuples_hi``, the largest per-peer relation of
     the simulator's defaults), k = 20, a (N, 16) f32 row table;
     ``fd-dynamic`` under each schedule (32 stacked requests through
     ``run_many``, and the row gather), ``cn`` and ``cn-star``; check
     that the top-k and merge counters moved and that the first 4
     queries equal the port's CPU path bit for bit; and one stacked
     ``fd-dynamic`` halving call of 4 queries at k = 512 (the top-k's
     select route), equal to the CPU path bit for bit;
  7. every registered topology family (the reference's full-size
     ``topology_sweep``: hierarchical at 100,000 peers, Waxman at 2,000,
     the others at 20,000, seed 7) under its native latency model
     (``"edge"`` where it carries coordinates, ``"iid"`` for BA):
     ``fd-dynamic``, origins (0, 1) x 2 independent trials, card == CPU
     path bit for bit, the sweep kernels held to their plain versions at
     each family's level shapes;
  8. reduced precision (the reference's ``precision`` and
     ``precision_scale`` suites): f32 and bf16 on the phase-3 overlay,
     the tolerance contract against the f64 rerun, card == CPU bits on
     4-entry static, churned (lifetime 60 s) and ``cn`` specs, warm
     ``run_s`` in f64 / f32 / bf16; the 1,000,000-peer star with an
     int32 plan in f32 (tolerance contract, build and run seconds);
  9. a live overlay (the reference's full-size ``overlay_dynamics``
     workload: hierarchical, 100,000 peers, seed 7; cut to 4 cached
     origins of its 16 and one session of its three, for time):
     a ``SimEngine`` bound to an ``Overlay`` on the card, then one
     leave, one join and a random session of 32 events, each
     followed by a timed incremental ``plan.sync()`` and a drained
     ``QueryServer`` batch (fd-dynamic over the 4 origins, 2 of them at
     lifetime 60 s, one fd-st1+2, and after each session one request
     from a departed peer); every served answer equal, bit for bit, to
     a card engine on a plan rebuilt from scratch (timed, with its
     upload) and to the port's CPU path on the synced plan (a process
     of its own that replays the same events on the same overlay while
     the card works, its plan's graph equal to the card's event by
     event), and after the first and the last event origin 0's answer
     to ``run_query_reference``; the merge, arrivals and both waits must
     launch on the served batches, and are held to their plain versions
     at the synced plan's shapes;
  10. the serving CLI as a user starts it,
     ``repro_torch.launch.serve.main(["overlay", ...])`` in process
     over 100,000-peer BA and hierarchical overlays on the card: 16
     requests (fd-dynamic and cn) from 8 clients all served, none shed,
     timed out or failed, the merge, arrivals and wait kernels launched,
     throughput and p50 / p95 / p99 printed beside the card; then entry
     sharding on the phase-3 overlay: 8 independent fd-dynamic entries
     in f64 and in validated f32 through ``SimEngine(shard=True)``
     (one card: the unsharded sweep, as in the reference) and through
     4 forced chunks of the card (f32 unvalidated), each equal to
     ``shard=False`` bit for bit (values, indices, every metric, the
     tolerance report where validated), the
     kernels launched and held to their plain versions at a chunk's
     shapes;
  11. the LM decode on the card: ``repro_torch.launch.serve.main(
     ["decode", "--arch", "qwen2-0.5b", "--batch", "4", "--prompt-len",
     "32", "--gen", "16", "--model-par", "16", "--device", "cuda"])`` in
     process (the reference's documented decode command without
     ``--smoke``: qwen2-0.5b's full width and depth, random weights, the
     vocabulary of 153,600
     sharded over 16 virtual peers): tokens (4, 16) inside the padded
     vocabulary, the top-k and merge launched on each of its 15 steps;
     the same model and prompt again with the device synchronised:
     prefill seconds, each step's seconds, the CLI's unsynchronised
     tok/s, and one profiler window of 5 steps split into the model's
     and the FD sampling's device time with the device's idle share;
     on one step's f32 scores the top-k on the card == the port's CPU
     path bit for bit under FD halving / doubling / ring, CN, CN* and at
     one peer (values == ``topk_ref`` of the whole row, indices too but
     under ring, whose tie order is its own), the sampled token equal
     given one noise tensor; qwen2-0.5b at full width and 2 layers in
     f32 with TF32 off, card == CPU path (prefill logits, padded caches,
     4 teacher-forced steps; rtol 1e-4, atol 1e-5, the measured error
     printed); the top-k at the decode's (64, 9,600), (4, 16, 9,600) and
     (4, 153,600) and the merge on each halving round's (4, 16, 20)
     lists (non-receivers masked to -inf / -1) bit-equal to their plain
     versions; its launches are the ``decode`` key of the kernels line's
     ``launches_by_path``;
  12. the attention variants on the card, each the phase-11 decode
     command (batch 4, prompt 32, 16 tokens, 16 peers): minicpm3-4b
     (MLA) and whisper-large-v3 (32 + 32 layers, cross attention over
     1,500 frames) at full size through ``serve.main(["decode", "--arch",
     ...])``, qwen2-vl-72b (M-RoPE, the vision stub) at full width and 4
     of its 80 layers (145.46 GB in bf16 does not fit one card) through
     ``init_params``, ``prefill``, ``state_from_prefill`` and
     ``make_serve_step``: tokens (4, 16) inside the padded vocabulary,
     top-k and merge launched on each of the 15 steps; at 8 layers (8 +
     8; cut for time) prefill seconds,
     synchronised steps, tok/s and a 2-step profiler window split into
     the model's and the sampling's device time with the idle share; an
     f32 cross-check at full width, card == CPU path within rtol 1e-4,
     atol 1e-5 with TF32 off (minicpm3-4b 2 layers, whisper 2 + 2
     layers over 1,500 frames, qwen2-vl 1 layer; batch 4); the top-k
     and merge at each arch's decode shapes bit-equal to their plain
     versions; launch keys ``variants_<arch>``;
  13. the last four archs on the card, each the same decode command at
     full size: granite-moe-1b-a400m (MoE, 32 experts, top-8) through
     ``serve.main(["decode", ...])``, moonshot-v1-16b-a3b (64 experts,
     top-6, 2 shared; 24 of its 48 layers, for time: 28.9 of 57.78 GB
     in bf16), rwkv6-3b (RWKV-6) and
     recurrentgemma-2b (RG-LRU and window attention, a 2,080-token
     prompt, so its 2,048-slot ring wraps while it decodes) through the
     CLI's functions: tokens (4, 16) inside the padded vocabulary,
     exactly 1 + (MoE layers) top-k and 4 merge launches a step (and a
     top-k a MoE layer in the prefill); recurrentgemma's rings holding
     the last 2,048 positions after decode; at 8 layers (cut for time)
     prefill seconds, synchronised
     steps, tok/s and a 2-step profiler window with the idle share; each
     MoE router's top-k on the card bit-equal to ``topk_ref`` on the
     probabilities captured from one prefill and one decode step; an f32
     cross-check at full width with TF32 off, the card's f32 == the CPU
     path run in f64 within rtol 1e-4, atol 1e-5 (MoE 2 layers, rwkv6-3b
     1, recurrentgemma 3, one whole group, its window cut to 16 slots so
     the 32-token prompt wraps it; the MoE's smallest router gap
     printed); the sampling's top-k and merge
     at each arch's shapes bit-equal to their plain versions; launch
     keys ``decode_<arch>``;
  14. the training path on the card: ``repro_torch.launch.train`` in
     process on granite-moe-1b-a400m at full size (bf16 weights, f32
     AdamW moments, batch 8, seq 128): 20 steps with finite losses and
     exactly 24 top-k launches a step (the routers, through the top-k
     kernel with its new gradient), the checkpoint of step 20 restored
     onto the card equal to the trained state bit for bit, and the
     checkpoint cycle of ``--ckpt-every 5`` through the same CLI with
     ``--smoke`` (a full-size checkpoint is 13.9 GB: the script writes
     one, not the cycle's six, 83 GB): checkpoints 10, 15 and 20 kept
     (keep 3 across the forced re-save, the repair of reference fault
     3), then a second call to 24 steps resuming from step 20 (at smoke
     size only, cut for time) and 15, 20 and 24 kept;
     granite (the CLI's settings) and qwen2-0.5b (2 microbatches, remat
     ``"dots"``) timed over repeated-batch steps whose loss must fall,
     one profiled step each (kernels, device ms, idle share) and
     ``max_memory_allocated``; granite's 24 router top-k calls of one
     step at (1,024, 32) k = 8 bit-equal to ``topk_ref``, the top-k's
     input gradient bit-equal to the scatter, 24 top-k launches a step
     and 48 under remat ``"full"`` and ``"dots"``; both archs at full
     width and 2 layers in f32 with TF32 off against the CPU path (loss
     rtol 1e-5, each gradient's relative L2 error at most 1e-4); its
     launches are the ``train`` key of ``launches_by_path``, and the
     router's training shape is timed under the top-k row's
     ``router_shapes``;
  15. FD across processes: 4 gloo ranks on the card (NCCL refuses two
     ranks on one card), spawned by ``launch.ranks.spawn_ranks`` with a
     time limit (a dead or hung rank fails the phase), each running
     ``tools/chip_ranks.py``: the ``DeviceEngine`` at phase 5's full
     width over 4 ranks x 16 local peers (every schedule, the row
     gather, CN, CN*, k = 512, and a (2, 64) data x model mesh laid out
     (2, 2) with ``batch_axes=("data",)``), each rank's answers equal
     to the one-process engine's on the card bit for bit (rank r's to
     ``_peer_lists``' row r * 16), every rank's top-k, select and merge
     counters moved, the bytes each call delivered across ranks printed
     beside the paper's model; then ``optim/compress.py``'s mean over
     the 4 ranks as pods at qwen2-0.5b's full parameter tree (f32,
     ``k_frac`` 1e-3, ``p_drop`` 0.05, two rounds, the second of zero
     gradients), each rank's ``g_hat`` and error feedback equal to the
     same computation with ``topk_ref`` on the card bit for bit, every
     rank's ``g_hat`` the same, the embedding leaf's sum in pod order
     equal to the CPU's, the k-list bytes beside the dense
     all-reduce's; its launches are the ``ranks`` key of
     ``launches_by_path``, and the largest leaf's top-k is timed under
     the select row's shapes;
  6. time each kernel (the churn variant at the churn sweep's level
     shapes) at the shapes its path gives it (CUDA events,
     median of several runs) beside its plain version, one PyTorch
     library call where one computes the same function (the merge:
     ``torch.sort`` stable, and ``torch.topk`` of the concatenation as a
     second yardstick, whose tie order differs), and its bound
     (bytes over the card's memory rate); ``device_ms`` is the kernel's
     own device time per timed call from one ``torch.profiler`` window
     (``library_device_ms`` the library call's), free of host gaps; the
     arrivals bound counts the distinct parents each row reads (beside
     it, ``bound_ms_whole_parent_level`` counts all of tq_prev), and its
     row lists each level's device time beside its bounds (``levels``);
     each sim kernel's row adds its f32 and bf16 times and bytes bound
     at the same shapes (``by_dtype``), and the waits' rows their f64
     device time by level; the select routes' row times them at (2048,
     20000) k = 512 and 4096 (resident) and (32, 1,280,000) k = 1,280
     (long), and phase 15's largest gradient leaf (1, 137,625,600) at
     k = 144,869 (long) beside ``torch.topk``, with each shape's route,
     its launches
     a call (the profiler must see the route's kernels, one launch each),
     their device ms, and the sort alone (``repro_topk_select_sort``,
     held to ``topk_ref``); the top-k row also times each decode's two
     shapes at k = 20, qwen2-0.5b's and qwen2-vl-72b's (64, 9,600) and
     (4, 153,600), minicpm3-4b's (64, 4,608) and (4, 73,728),
     whisper-large-v3's (64, 3,328) and (4, 53,248), and phase 13's
     four archs', beside ``torch.topk`` (``decode_shapes``), and the MoE
     routers' (4, 32) / (128, 32) at k = 8 and (4, 64) / (128, 64) at
     k = 6 on captured probabilities (``router_shapes``).  A profiler window that misses
     one of the launches it should hold is taken again, up to 3 windows.
  17. (before phase 16) the dry run's counter held to the card:
     ``roofline/trace.py::analyze`` of phase 14's granite-moe-1b-a400m
     train step (batch 8, seq 128) and of phase 11's qwen2-0.5b decode
     step (batch 4, 16 vocabulary peers), each once on fake card tensors
     and once on the real step: equal FLOPs and bytes, the kernel calls
     equal to the launches the step made (24 top-k a granite step; a
     top-k and 4 merges a decode step), the fake trace's peak within
     1% of ``max_memory_allocated``; each step timed (synchronised)
     beside its data-sheet bound from ``roofline_terms`` and the share;
     and ``python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b
     --shape decode_32k`` as a process (exit 0, a top-k and 4 merges on
     fake card tensors, its record under ``artifacts/dryrun_torch``)
     whose rank holds what ``decode_state_specs`` places of the decode
     state (its caches' sequence over the 16 model ranks:
     ``memory.cache_gib == memory.specs_cache_gib``),
     and a smoke-size granite train cell (full remat) on the 256-rank
     fake world on fake card tensors, whose bytes sent equal
     ``tools/chip_train_ranks.py::predicted_bytes`` with the
     recompute's replays (these two processes run beside phase 10, and
     are waited for at its end).  Its launches are not in the kernels
     line.
  16. (run last, after the timing windows, then one profiler window
     as a probe) training and serving across ranks, the products split
     over the model ranks: 4 gloo ranks on the card
     (``tools/chip_train_ranks.py`` on each, under ``spawn_ranks`` with
     a time limit), as (data 2, model 2) and as (data 1, model 4):
     ``launch.train.build`` over the group keeps each rank's blocks of
     granite-moe-1b-a400m at full size (``optim/sharding.py::
     param_specs``; a leaf the specs put over ``model`` stays a block
     through the step) for 2 steps at each layout ((2, 2) cut from 3
     for time) of batch
     8, seq 128, every rank with the same loss and norm bits, each
     leaf's replicas (the replicated leaves across the model ranks too)
     equal bit for bit, exactly 24 top-k launches a step on each rank,
     the bytes each rank delivers a step over each axis equal to the
     reckoned count (the specs' gathers and reduce-scatters over
     ``data``; the model axis's activations, ``model_axis_events``), the
     parameter bytes a step gathers equal to the data-only reckoning,
     its step time and ``max_memory_allocated`` printed; at each layout
     the same arch at
     full width and 2 layers in f32 (TF32 off), one step over the ranks
     against one process over a mesh of virtual peers of that shape
     (loss rtol 1e-5, the norm and each parameter's relative L2 error
     after the update 1e-4), the (2, 2) checkpoint restored onto 2
     ranks and onto one process bit for bit; rank 0's (2, 2) step traced
     by ``roofline/trace.py`` against phase 17's fake trace of the same
     step on a fake 4-rank world (equal FLOPs, bytes and kernel calls);
     ``serve decode`` of qwen2-0.5b and granite at full size over (2, 2)
     (phase 11's command, the 16 vocabulary peers over the 2 model
     ranks): in f32 (TF32 off) with the tokens of one process decoding
     each data block's rows, and in bf16 with the same tokens on every
     rank and each rank's block of the prompt's last logits and of a
     first step's logits within 3 times the one-process bf16 logits' own
     rounding (their L2 distance from f32 on the same weights) of their
     columns (the tokens' agreement with one process's printed: the
     split products round otherwise), the bytes across ranks by axis
     and tok/s printed; the same decodes over (1, 4) in f32 against one
     process's decode of the whole batch (qwen2-0.5b's tokens equal;
     for granite, one process in f32 and f64 fed the ranks' router
     choices differs from them only where two experts tie (f64 margin
     at most 3 times the margins' own f32 rounding) and the ranks'
     logits blocks lie within 3 times one process's f32-f64 rounding
     of its columns, the tokens' agreement printed: one process's f32
     routers turn at such a tie); and ``TR_WIDE``'s decodes
     over (1, 4), one vocabulary peer a rank, in f32 at full width and
     cut depth (recurrentgemma-2b one mixer group with phase 13's
     2,080-token prompt, its ring wrapping; minicpm3-4b 2 layers;
     whisper-large-v3 2 + 2 layers) against one process.  With S_max 48
     every decode's caches hold each rank's block of their sequence
     (S_max, the window's 2,048 slots, whisper's 1,500 frames at 4
     model peers) for every KV head: each rank's attention cache bytes
     == ``chip_train_ranks.decode_state_layout``'s block, the caches
     cut == those the rule cuts, and one more decode step's bytes ==
     ``model_axis_events``
     on the model axis and nothing on the data axis; its launches are
     the ``train_serve_ranks`` key of ``launches_by_path``.

The line before the last is the ``kernels`` JSON object; the last line
is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: HBM3 rate and the float64 non-tensor rate
# (the timed calls run in f64; their compares and adds count against it)
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 34e12
# the float32 non-tensor rate, for the top-k's compares of f32 keys
OPS32_PER_S = 67e12
N_PEERS = 100_000
E_MAIN = 32
# the device path: the paper's 64-node cluster, SimParams.tuples_hi
# scores per peer, SimParams.k, a row width of the reference's gather
# tests, and the serve path's batch
DEV_PEERS = 64
DEV_LOCAL = 20_000
DEV_K = 20
# a k above the top-k's tile route (MAX_K = 256): the select route
DEV_K_LARGE = 512
DEV_D = 16
DEV_B = 32


class PhaseError(RuntimeError):
    """A phase found a fault."""


def _require(cond, msg):
    if not cond:
        raise PhaseError(msg)


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps=7, warm=2):
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _profiled(body, tries=4):
    """A ``torch.profiler`` window around ``body()`` that holds every
    kernel ``body`` launches.  Late in a long run on the H100 a window
    loses its first 1 to 3 kernel records, whatever the pause before
    them (seen once a window had held 13,500 kernels: from then on every
    window lost its first record, a 1 s pause or none).  So marker
    kernels (``torch.cuda._sleep``: ``spin_kernel``) go ahead
    of ``body`` on its stream: a trace that holds one of them holds
    every kernel after it.  A window that lost every marker is taken
    again with twice as many, up to ``tries`` windows; the first holds
    64 (windows of 8 and 16 lost every one most of the time in a full
    run, each retake costing a window).  Returns the profiler; its
    markers lie outside every :func:`tagged` range and are left out of
    every sum."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    markers = 64
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(markers):
                torch.cuda._sleep(100)
            body()
            torch.cuda.synchronize()
        if any(ev.device_type == DeviceType.CUDA and _MARKER in ev.name
               for ev in prof.events()):
            return prof
        print(f"[profiler] window {attempt} of {tries} lost all {markers} "
              "markers; taken again")
        markers *= 2
    raise PhaseError(f"no profiler window of {tries} held a marker")


_MARKER = "spin_kernel"


def _device_ms(fn, match=None, reps=10, tries=3):
    """Device milliseconds of one call of ``fn``: the CUDA time of the
    kernels whose names hold one of ``match`` (all kernels when None),
    summed over one ``torch.profiler`` window around ``reps`` calls and
    divided by ``reps``.  A window that saw no such kernel is taken
    again, up to ``tries`` windows, then None."""
    from torch.autograd import DeviceType
    fn()
    for _ in range(tries):
        prof = _profiled(lambda: [fn() for _ in range(reps)])
        us = 0.0
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA or _MARKER in ev.key:
                continue
            if match is not None and not any(m in ev.key for m in match):
                continue
            us += getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            return us / 1e3 / reps
    return None


def _device_ms_each(fn, n_launch, match, reps=10, tries=3):
    """Device milliseconds of each of the ``n_launch`` kernels (names
    holding ``match``, a string or a tuple of them) that one call of
    ``fn`` launches, in launch order, each the mean over ``reps`` calls
    in one ``torch.profiler`` window.  A window in which the profiler
    did not see ``n_launch * reps`` such kernels is taken again, up to
    ``tries`` windows, then None."""
    from torch.autograd import DeviceType
    match = (match,) if isinstance(match, str) else tuple(match)
    fn()
    for attempt in range(1, tries + 1):
        prof = _profiled(lambda: [fn() for _ in range(reps)])
        ks = sorted((ev.time_range.start, ev.time_range.elapsed_us())
                    for ev in prof.events()
                    if ev.device_type == DeviceType.CUDA
                    and any(m in ev.name for m in match))
        if len(ks) == n_launch * reps:
            return [statistics.fmean(us for _, us in ks[i::n_launch]) / 1e3
                    for i in range(n_launch)]
        print(f"[times] profiler window {attempt} of {tries} saw "
              f"{len(ks)} {'/'.join(match)} kernels of {n_launch * reps}")
    return None


_BITS = {2: "int16", 4: "int32", 8: "int64"}


def _same(a, b):
    """Equal shapes, dtypes and bits (NaNs and signed zeros included)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        bits = getattr(torch, _BITS[a.element_size()])
        a, b = a.view(bits), b.view(bits)
    return torch.equal(a, b)


def _max_abs_err(a, b):
    """Largest |a - b| over the positions where the bits differ (0.0
    when equal; inf when a mismatch involves an infinity or a NaN; 0.0
    when only the sign of a zero or a NaN's payload differs)."""
    import torch
    if _same(a, b):
        return 0.0
    diff = a.ne(b) | (a.isnan() ^ b.isnan())
    d = (a[diff].double() - b[diff].double()).abs()
    d = torch.nan_to_num(d, nan=math.inf)
    return float(d.max()) if d.numel() else 0.0


# +0.0, -0.0, +inf, -inf, +NaN, -NaN and a NaN with a payload, as the
# signed integers of their bits
_SPECIALS = {
    "torch.float64": [0, -2 ** 63, 0x7FF0000000000000, -4503599627370496,
                      0x7FF8000000000000, -2251799813685248,
                      0x7FF8000000000001],
    "torch.float32": [0, -2 ** 31, 0x7F800000, -8388608, 0x7FC00000,
                      -4194304, 0x7FC00001],
    "torch.bfloat16": [0, -32768, 0x7F80, -128, 0x7FC0, -64, 0x7FC1],
    "torch.float16": [0, -32768, 0x7C00, -1024, 0x7E00, -512, 0x7E01],
}


def _with_specials(v, gen, frac):
    """``v`` with a fraction ``frac`` of its entries replaced by signed
    zeros, infinities and NaNs of both signs (set as bits)."""
    import torch
    bits = getattr(torch, _BITS[v.element_size()])
    table = torch.tensor(_SPECIALS[str(v.dtype)], dtype=bits,
                         device=v.device)
    pick = torch.randint(0, len(table), v.shape, generator=gen,
                         device=v.device)
    hit = torch.rand(v.shape, generator=gen, device=v.device) < frac
    return torch.where(hit, table[pick], v.view(bits)).view(v.dtype)


def _sorted_lists(shape, k, dtype, gen, dev, ties=True, specials=False):
    """Descending (values, owners) k-lists; with ``ties`` the values come
    from a small lattice (many equal scores) and rows get random -inf
    tails, as the sweep's padded lists have; with ``specials`` a quarter
    of the values are signed zeros, infinities and NaNs, and the lists
    are sorted in the reference's total order (``lax.top_k``'s)."""
    import torch
    from repro_torch.kernels.order import take_bits, total_order_key
    if ties:
        v = torch.randint(0, k + 2, shape + (k,), generator=gen,
                          device=dev).to(dtype) / (k + 2)
    else:
        v = torch.rand(shape + (k,), generator=gen, device=dev,
                       dtype=torch.float64).to(dtype)
    v = v.sort(dim=-1, descending=True).values
    if ties:
        n_inf = torch.randint(0, k + 1, shape + (1,), generator=gen,
                              device=dev)
        pos = torch.arange(k, device=dev)
        v = torch.where(pos >= k - n_inf, float("-inf"), v).to(dtype)
    if specials:
        v = _with_specials(v, gen, 0.25)
        order = torch.sort(total_order_key(v), dim=-1, descending=True,
                           stable=True).indices
        v = take_bits(v, order)
    o = torch.randint(0, 1 << 30, shape + (k,), generator=gen, device=dev,
                      dtype=torch.int32)
    return v.contiguous(), o


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _check_merge_plan(dev):
    """The library plans as the wrapper does (``merge_plan``) for every
    route request, element size and alignment at the plan's edges (the
    tile rows and one off, the bulk threshold, more rows than the grid
    takes), and its launcher refuses any other plan."""
    import ctypes
    import torch
    import repro_torch.kernels.merge.merge as wrapper
    from repro_torch.kernels import _build
    LL, I = ctypes.c_longlong, ctypes.c_int
    plan_fn = _build.function("merge", "repro_merge_plan",
                              [LL, LL, I, I, I, ctypes.c_void_p])
    buf = (LL * 8)()
    n = 0
    for rows in (1, 15, 17, 23, 25, 31, 33, 2047, 2048, 4223, 4224, 6400,
                 32767, 32768, 70_001, 95_999, 96_000, 670_976, 2 ** 31 + 5,
                 2 ** 33):
        for k in (1, 3, 20, 32, 33, 512, 513, 4096):
            for size in (8, 4, 2):
                for aligned in (True, False):
                    for route, flag in ((None, -1), (wrapper.BULK, 0),
                                        (wrapper.DIRECT, 1), (wrapper.ROW, 2)):
                        try:
                            want = tuple(int(x) for x in wrapper.merge_plan(
                                rows, k, size, () if aligned else (8,),
                                route=route))
                        except ValueError:
                            want = None
                        code = plan_fn(rows, k, size, int(aligned), flag,
                                       ctypes.cast(buf, ctypes.c_void_p))
                        got = None if code else tuple(buf)
                        _require(got == want, f"merge plan rows={rows} k={k}"
                                 f" itemsize={size} aligned={aligned} route="
                                 f"{route}: library {got}, wrapper {want}")
                        n += 1
    # the launcher refuses a plan other than its own
    fn = _build.function("merge", "repro_merge_f32", wrapper._ARGTYPES)
    rows = 100_000
    v = torch.zeros((rows + 1, 32), dtype=torch.float32, device=dev)
    o = torch.zeros((rows + 1, 32), dtype=torch.int32, device=dev)
    p = wrapper.merge_plan(rows, 32, 4)
    _require(p.route == wrapper.BULK, f"merge plan of a large f32 launch: "
             f"{p}")
    st = torch.cuda.current_stream().cuda_stream
    for what, base, route, R, grid in (
            ("rows a tile", 0, p.route, p.rows_per_tile + 1, p.grid),
            ("grid", 0, p.route, p.rows_per_tile, p.grid - 1),
            ("route", 0, 3, p.rows_per_tile, p.grid),
            ("bulk route off 16 bytes", 4, p.route, p.rows_per_tile, p.grid)):
        va = v.data_ptr() + base
        code = fn(va, o.data_ptr(), va, o.data_ptr(), None, None, va,
                  o.data_ptr(), rows, 32, route, R, grid, st)
        _require(code != 0, f"merge launcher took another {what}")
        n += 1
    return n


def _nan_out(shape, dt, dev):
    """Outputs filled with NaN / -7, so that a skipped element shows."""
    import torch
    return (torch.full(shape, float("nan"), dtype=dt, device=dev),
            torch.full(shape, -7, dtype=torch.int32, device=dev))


def _one_row_in(t):
    """``t`` as a contiguous view one row into a larger tensor."""
    import torch
    big = torch.empty((t.shape[0] + 1,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    big[1:].copy_(t)
    return big[1:]


def _merge_lists(rows, k, dt, gen, dev):
    """Two descending (values, owners) list sets for phase 2: lattice
    values with ties, -inf tails and specials for the float types, small
    integers (ties) for int32."""
    import torch
    out = []
    for _ in range(2):
        if dt == torch.int32:
            v = torch.randint(-50, 50, (rows, k), generator=gen, device=dev,
                              dtype=torch.int32).sort(
                                  dim=-1, descending=True).values
            o = torch.randint(0, 1 << 30, (rows, k), generator=gen,
                              device=dev, dtype=torch.int32)
        else:
            v, o = _sorted_lists((rows,), k, dt, gen, dev, specials=True)
        out += [v.contiguous(), o]
    return out


def _check_merge(gen, dev, errs):
    """The merge bit-equal to ``merge_ref``, into outputs filled with NaN:
    lattice lists with specials and masks at (3, 37); then at k of 1, 3,
    20, 32, 33, 512, 513 and 4096, at rows of 1, a tile's rows R - 1 and
    R + 1 (the ring's at k = 32, else the plan's) and 70,001 (k <= 64;
    1,000 to k = 513 and 65 at 4096), on fresh tensors with and without
    masks and on contiguous views one row into a larger tensor (bases
    off 16 bytes where a row is not a multiple of 16 bytes): in f64, f32
    and bf16 the wrapper's own plan (every error raised) and each route
    (bulk, direct, row) that ``merge_plan`` says can take the lists, and
    f16 and int32 through the promotion to f32, at least one case each
    k and type; an f16 list with an f32 one, both with NaNs of both
    signs; and the refusal of f32 lists with f64 or bf16 ones."""
    import torch
    import repro_torch.kernels.merge.merge as wrapper
    from repro_torch.kernels.merge import merge_cuda, merge_ref
    n = _check_merge_plan(dev)
    for k in (1, 7, 20, 32, 64, 256):
        for dt in (torch.float64, torch.float32, torch.bfloat16):
            lead = (3, 37)
            for specials in (False, True):
                va, ia = _sorted_lists(lead, k, dt, gen, dev,
                                       specials=specials)
                vb, ib = _sorted_lists(lead, k, dt, gen, dev,
                                       specials=specials)
                ma = torch.rand(lead, generator=gen, device=dev) < 0.7
                mb = torch.rand(lead, generator=gen, device=dev) < 0.7
                for masks in ({}, {"valid_a": ma, "valid_b": mb},
                              {"valid_b": mb}):
                    v1, i1 = merge_cuda(va, ia, vb, ib, **masks,
                                        out=_nan_out(va.shape, dt, dev))
                    v2, i2 = merge_ref(va, ia, vb, ib, **masks)
                    err = _max_abs_err(v1, v2)
                    errs["merge"] = max(errs["merge"], err)
                    _require(_same(v1, v2) and _same(i1, i2),
                             f"merge k={k} {dt} masks={sorted(masks)} "
                             f"specials={specials}: kernel != plain "
                             f"version (max abs err {err})")
                    n += 1
    for k in (1, 3, 20, 32, 33, 512, 513, 4096):
        for dt in (torch.float64, torch.float32, torch.bfloat16,
                   torch.float16, torch.int32):
            promoted = dt in (torch.float16, torch.int32)
            cdt = torch.float32 if promoted else dt
            R = wrapper.merge_plan(
                1 << 20, k, cdt,
                route=wrapper.BULK if k == wrapper.BULK_K else None
            ).rows_per_tile
            big = 70_001 if k <= 64 else 1_000 if k <= 513 else 65
            compared = 0
            for rows in sorted({1, max(R - 1, 1), R + 1, big}):
                va, ia, vb, ib = _merge_lists(rows, k, dt, gen, dev)
                ma = torch.rand(rows, generator=gen, device=dev) < 0.7
                mb = torch.rand(rows, generator=gen, device=dev) < 0.7
                layouts = (("fresh", (va, ia, vb, ib), {}),
                           ("fresh, masked", (va, ia, vb, ib),
                            {"valid_a": ma, "valid_b": mb}),
                           ("one row in, masked",
                            tuple(_one_row_in(t) for t in (va, ia, vb, ib)),
                            {"valid_a": ma, "valid_b": mb}))
                for what, lists, masks in layouts:
                    v2, i2 = merge_ref(*lists, **masks)
                    # the wrapper's own plan, then each route forced where
                    # the plan says it can take these lists (promoted
                    # lists are cast inside the wrapper: their own plan)
                    for route in (None,) if promoted else (
                            None, wrapper.BULK, wrapper.DIRECT, wrapper.ROW):
                        out = _nan_out(v2.shape, v2.dtype, dev)
                        if route is not None:
                            ptrs = [t.data_ptr() for t in (*lists, *out)]
                            try:
                                wrapper.merge_plan(rows, k, cdt, ptrs,
                                                   route=route)
                            except ValueError:
                                continue        # a route these cannot take
                        v1, i1 = wrapper._merge(
                            *lists, masks.get("valid_a"),
                            masks.get("valid_b"), route, out)
                        err = _max_abs_err(v1, v2)
                        errs["merge"] = max(errs["merge"], err)
                        _require(_same(v1, v2) and _same(i1, i2),
                                 f"merge k={k} {dt} rows={rows} {what} "
                                 f"route={route}: kernel != plain version "
                                 f"(max abs err {err})")
                        compared += 1
            _require(compared > 0, f"merge k={k} {dt}: no case compared")
            n += compared
    # an f16 list with an f32 one merges in f32; lists of two types that
    # do not promote to one are refused
    for k in (20, 32):
        (va, ia), (vb, ib) = (
            _sorted_lists((4_001,), k, t, gen, dev, specials=True)
            for t in (torch.float16, torch.float32))
        for a, b in (((va, ia), (vb, ib)), ((vb, ib), (va, ia))):
            v2, i2 = merge_ref(*a, *b)
            v1, i1 = merge_cuda(*a, *b, out=_nan_out(v2.shape, v2.dtype,
                                                     dev))
            _require(v1.dtype == torch.float32 and _same(v1, v2)
                     and _same(i1, i2), f"merge k={k} f16 with f32: "
                     f"kernel != plain version")
            n += 1
        for t in (torch.float64, torch.bfloat16):
            try:
                merge_cuda(vb, ib, vb.to(t), ib)
            except ValueError:
                n += 1
            else:
                _require(False, f"merge took f32 with {t} lists")
    return n


def _topk_input(rows, n, dtype, gen, dev):
    """Scores on a lattice (many ties, +0.0 among them), 2% signed
    zeros, infinities and NaNs, a random -inf tail per row, and row 0
    all -inf (its -inf entries must keep their real indices)."""
    import torch
    v = ((torch.randint(0, 17, (rows, n), generator=gen, device=dev) - 8)
         .to(torch.float32) / 8).to(dtype)
    v = _with_specials(v, gen, 0.02)
    tail = torch.randint(0, n // 4 + 1, (rows, 1), generator=gen,
                         device=dev)
    pos = torch.arange(n, device=dev)
    v = torch.where(pos >= n - tail, float("-inf"), v).to(dtype)
    v[0] = float("-inf")
    return v.contiguous()


def _topk_adversarial(dtype, gen, dev):
    """(name, scores) pairs that break selections by counting: more than
    k scores tied at the k-th key across several tiles, one repeated
    value, rows one short of, at and one past the tile width, signed
    zeros, infinities and NaNs at the threshold, an all -inf row."""
    import torch
    from repro_torch.kernels.topk.topk import TILE
    out = []
    for n in (TILE - 1, TILE, TILE + 1, 3 * TILE + 5):
        # 4 levels: the top level holds ~n/4 scores in every tile
        lat = (torch.randint(0, 4, (4, n), generator=gen, device=dev)
               .to(torch.float32) / 4).to(dtype)
        out.append((f"lattice n={n}", lat))
    n = 3 * TILE + 5
    rare = torch.zeros((3, n), device=dev)
    # exactly 40 scores of 1.0, in the last tiles first, and the rest a
    # tie of +0.0 and -0.0; row 2 has its 1.0s at the tile seams
    pos = torch.randperm(n, generator=gen, device=dev)[:40]
    rare[0, pos] = 1.0
    rare[1, n - 40:] = 1.0
    seams = torch.tensor([TILE - 1, TILE, 2 * TILE - 1, 2 * TILE, n - 1],
                         device=dev)
    rare[2, seams] = 1.0
    rare[:, 1::2] = torch.where(rare[:, 1::2] == 0, -0.0, rare[:, 1::2])
    out.append(("few winners over tiles, +-0 ties", rare.to(dtype)))
    for v in (0.5, -0.0, float("-inf"), float("nan"), float("inf")):
        out.append((f"all {v}", torch.full((2, TILE + 1), v, device=dev)
                    .to(dtype)))
    # only signed zeros, infinities and NaNs: the k-th key is a special
    spec = _with_specials(torch.zeros((4, 2 * TILE + 3), device=dev)
                          .to(dtype), gen, 1.0)
    out.append(("specials only", spec))
    return out


def _check_topk_plan(dev):
    """The built library tiles as the wrapper plans, and its launcher
    refuses any other plan (the wrapper computes tiles and scratch)."""
    import ctypes
    import torch
    import repro_torch.kernels.topk.topk as wrapper
    from repro_torch.kernels import _build
    tile = _build.function("topk", "repro_topk_tile", [])()
    _require(tile == wrapper.TILE, f"topk: library tiles by {tile}, the "
             f"wrapper by {wrapper.TILE}")
    fn = _build.function("topk", "repro_topk_f32", wrapper._ARGTYPES)
    n, k = wrapper.TILE + 1, 20
    x = torch.zeros((1, n), device=dev)
    vo = torch.empty((1, k), device=dev)
    io = torch.empty((1, k), dtype=torch.int32, device=dev)
    cand = torch.empty((1, 2 * k), dtype=torch.int64, device=dev)
    for tiles, c in ((1, cand), (3, cand), (2, None)):
        code = fn(x.data_ptr(), 1, n, k, 0, tiles,
                  None if c is None else c.data_ptr(), vo.data_ptr(),
                  io.data_ptr(), torch.cuda.current_stream().cuda_stream)
        _require(code != 0, f"topk launcher took {tiles} tiles for n={n} "
                 f"(scratch {'given' if c is not None else 'missing'})")
    # the select routes (k > MAX_K): the library plans as the wrapper
    # does, at the resident route's largest row and one either side too,
    # and its launcher refuses the other route's plan, other tiles, no
    # scratch, and a k the tile route takes
    LL = ctypes.c_longlong
    sel_plan = _build.function("topk_select", "repro_topk_select_plan",
                               [LL, ctypes.c_int, ctypes.c_void_p])
    buf = (LL * 2)()
    n_checks = 3
    edges = []
    for k in (257, 512, 1_280, 4096):
        top = _resident_max_n(wrapper, k)
        edges += [(top - 1, k), (top, k), (top + 1, k)]
        _require((wrapper.plan(top, k).route, wrapper.plan(top + 1, k).route)
                 == (wrapper.RESIDENT, wrapper.LONG),
                 f"topk select: the route does not change after n={top} "
                 f"at k={k}")
    for n, k in edges + [(n, k) for n in (1, 256, 257, 4096, 16_384, 16_385,
                                          20_000, 1_280_000, 2 ** 31 - 1)
                         for k in (1, 256, 257, 512, 1_280, 4096, 20_000)]:
        want = None
        if wrapper.MAX_K < k <= n:
            want = tuple(wrapper.plan(n, k)[1:])
        code = sel_plan(n, k, ctypes.cast(buf, ctypes.c_void_p))
        got = None if code else tuple(buf)
        _require(got == want, f"topk select plan n={n} k={k}: library "
                 f"{got}, wrapper {want}")
        n_checks += 1
    sel = _build.function("topk_select", "repro_topk_select_f32",
                          wrapper._ARGTYPES)
    k = 512
    top = _resident_max_n(wrapper, k)
    res, long_ = wrapper.plan(top, k), wrapper.plan(top + 1, k)
    for n, tiles, words, what in (
            (top, long_.tiles, long_.words, "the long route's plan"),
            (top + 1, res.tiles, res.words, "the resident route's plan"),
            (top + 1, long_.tiles + 1, long_.words, "other tiles"),
            (top + 1, long_.tiles, 0, "no scratch"),
            (top, 0, 0, "k = 256")):
        kk = 256 if what == "k = 256" else k
        x = torch.zeros((1, n), device=dev)
        scratch = torch.empty((1, max(words, long_.words)),
                              dtype=torch.int64, device=dev)
        vo = torch.empty((1, kk), device=dev)
        io = torch.empty((1, kk), dtype=torch.int32, device=dev)
        code = sel(x.data_ptr(), 1, n, kk, 0, tiles,
                   scratch.data_ptr() if words else None, vo.data_ptr(),
                   io.data_ptr(), torch.cuda.current_stream().cuda_stream)
        _require(code != 0, f"topk select launcher took {what} for n={n} "
                 f"k={kk}")
        n_checks += 1
    return n_checks


def _resident_max_n(wrapper, k):
    """The largest row the resident route takes at k."""
    n = (wrapper.RESIDENT_SMEM - wrapper.FIXED_BYTES - 8 * k) // 4 - 4
    while wrapper.resident_bytes(n, k) > wrapper.RESIDENT_SMEM:
        n -= 1
    return n


_TOPK_KS = (1, 8, 20, 64, 256, 257, 512, 1_280, 4096)


def _check_topk_case(what, x, k, off, errs):
    """The top-k kernel of k's route bit-equal to ``topk_ref``."""
    from repro_torch.kernels.topk import topk_cuda, topk_ref
    from repro_torch.kernels.topk.topk import MAX_K
    v1, i1 = topk_cuda(x, k, index_offset=off)
    v2, i2 = topk_ref(x, k, index_offset=off)
    err = _max_abs_err(v1, v2)
    name = "topk" if k <= MAX_K else "topk_select"
    errs[name] = max(errs[name], err)
    _require(_same(v1, v2) and _same(i1, i2),
             f"topk {what} k={k} {x.dtype}: kernel != plain version "
             f"(max abs err {err})")


def _check_topk(gen, dev, errs):
    """Every route (tiles to k = 256; resident and long above) on the
    inputs that break selections by counting, n == k, the device path's
    widths with specials and ties, at k to 4096, and the resident
    route's largest row and one either side."""
    import torch
    n_checks = _check_topk_plan(dev)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        cases = _topk_adversarial(dt, gen, dev)
        for k in _TOPK_KS:
            # n == k: the row is its own top-k
            cases.append((f"n == k={k}", _topk_input(3, k, dt, gen, dev)))
        for what, x in cases:
            for k in _TOPK_KS:
                if k > x.shape[-1]:
                    continue
                _check_topk_case(what, x, k, 7, errs)
                n_checks += 1
    # 20,485 leaves a last tile of 5 scores, fewer than k (empty slots
    # in the candidates); 1,280,000 is the CN shape of the device path
    for n, rows in ((128, 64), (777, 16), (4080, 4), (4096, 8),
                    (20_000, 8), (20_485, 4), (1_280_000, 2)):
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            x = _topk_input(rows, n, dt, gen, dev)
            for k in _TOPK_KS:
                if k > n:
                    continue
                _check_topk_case(f"n={n}", x, k, 1000 * k, errs)
                n_checks += 1
    # the select routes' edge: rows one short of, at and one past the
    # largest the resident route takes at k = 512; and rows of one
    # repeated value and of ties at the k-th key across the long route's
    # tiles, long at every k (4 full tiles and one of 7 scores, past the
    # resident route's largest row at k = 257)
    import repro_torch.kernels.topk.topk as wrapper
    top = _resident_max_n(wrapper, 512)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        cases = []
        for n in (top - 1, top, top + 1):
            lat = (torch.randint(0, 4, (2, n), generator=gen, device=dev)
                   .to(torch.float32) / 4).to(dt)
            cases.append((f"lattice n={n}", lat, (512,)))
            cases.append((f"specials n={n}", _topk_input(2, n, dt, gen, dev),
                          (512,)))
            cases.append((f"all 0.5 n={n}",
                          torch.full((1, n), 0.5, device=dev).to(dt),
                          (512,)))
        n = 4 * wrapper.LTILE + 7
        for k in (257, 512, 1_280, 4096):
            _require(wrapper.plan(n, k).route == wrapper.LONG,
                     f"topk select: n={n} k={k} is not a long row")
        cases.append((f"all 0.5 n={n}",
                      torch.full((2, n), 0.5, device=dev).to(dt),
                      (257, 512, 1_280, 4096)))
        lat = (torch.randint(0, 2, (2, n), generator=gen, device=dev)
               .to(torch.float32) / 2).to(dt)
        cases.append((f"ties across tiles n={n}", lat,
                      (257, 512, 1_280, 4096)))
        for what, x, ks in cases:
            for k in ks:
                _check_topk_case(what, x, k, 7, errs)
                n_checks += 1
    return n_checks


def _arrivals_cases(levels, gen, dev):
    """(name, E, L_prev, par_pos) of phase 2's arrivals checks: the
    path's level shapes, then the plan's edges: one entry row, one
    column, one parent, an odd row count, an odd width (rows that start
    off the 16-byte boundaries), rows past the grid's y extent (on z),
    int64 positions, repeated parents."""
    import torch
    cases = []
    for d in range(1, len(levels)):
        cases.append((f"level {d}", E_MAIN, levels[d - 1]["vv"].shape[0],
                      levels[d]["par_pos"]))
    big = max(range(1, len(levels)), key=lambda d: len(levels[d]["vv"]))
    big_pp, big_lp = levels[big]["par_pos"], levels[big - 1]["vv"].shape[0]

    def rand_pos(L, Lp):
        return torch.randint(0, Lp, (L,), generator=gen, device=dev,
                             dtype=torch.int32)

    cases += [
        ("E=1", 1, big_lp, big_pp),
        ("L=1", E_MAIN, 7, rand_pos(1, 7)),
        ("L_prev=1", E_MAIN, 1, rand_pos(1000, 1)),
        ("E=37", 37, big_lp, big_pp),
        ("E=13, L=1001", 13, 333, rand_pos(1001, 333)),
        ("E=70,000 (rows on z)", 70_000, 5, rand_pos(3, 5)),
        ("int64 positions", E_MAIN, big_lp, big_pp.long()),
        ("repeated parents", E_MAIN, 5000, rand_pos(20_000, 3) * 1777),
    ]
    return cases


def _check_arrivals_plan(dev):
    """The library plans as the wrapper does (``arrivals_plan``) at the
    path's level shapes, the edges and shapes whose offsets need 64
    bits, for every element size, alignment and staging request, and
    its launcher refuses any other plan."""
    import ctypes
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.sweep.sweep import (_ARRIVALS_ARGTYPES,
                                                 arrivals_plan)
    LL, I = ctypes.c_longlong, ctypes.c_int
    plan_fn = _build.function("sweep", "repro_arrivals_plan",
                              [LL, LL, LL, I, I, I, ctypes.c_void_p])
    buf = (LL * 9)()
    shapes = [(32, 308, 1), (32, 3837, 308), (32, 24120, 3837),
              (32, 51529, 24120), (32, 19690, 51529), (32, 515, 19690),
              (1, 51529, 24120), (32, 1, 7), (32, 1000, 1),
              (37, 51529, 24120), (13, 1001, 333), (70_000, 3, 5),
              (200, 40_000, 20_000), (32, 2 ** 26, 1000),
              (1, 2 ** 31 - 2 ** 17, 9), (1, 2 ** 31 - 2 ** 17 - 1, 9),
              (65_535, 1, 1), (65_536, 1, 1), (65_535 ** 2, 1, 1),
              (65_535 ** 2 + 1, 1, 1)]
    n = 0
    for E, L, Lp in shapes:
        for size in (8, 4, 2):
            for aligned in (True, False):
                for staged, flag in ((None, -1), (False, 0), (True, 1)):
                    try:
                        want = tuple(int(x) for x in arrivals_plan(
                            E, L, Lp, size, aligned=aligned, staged=staged))
                    except ValueError:
                        want = None
                    code = plan_fn(E, L, Lp, size, int(aligned), flag,
                                   ctypes.cast(buf, ctypes.c_void_p))
                    got = None if code else tuple(buf)
                    _require(got == want, f"arrivals plan E={E} L={L} "
                             f"Lp={Lp} itemsize={size} aligned={aligned} "
                             f"staged={staged}: library {got}, wrapper "
                             f"{want}")
                    n += 1
    # the launcher refuses a plan other than its own
    fn = _build.function("sweep", "repro_arrivals_f64_i32",
                         _ARRIVALS_ARGTYPES)
    tq = torch.zeros((E_MAIN, 100), dtype=torch.float64, device=dev)
    dn = torch.zeros((E_MAIN, 24120), dtype=torch.float64, device=dev)
    pp = torch.zeros(24120, dtype=torch.int32, device=dev)
    out = torch.empty_like(dn)
    p = arrivals_plan(E_MAIN, 24120, 100, 8)
    _require(p.staged and p.vec == 2, f"arrivals plan of a large dense "
             f"level: {p}")
    for what, vec, staged, wide in (("vector width", 1, 1, 0),
                                    ("gather", 2, 0, 0),
                                    ("staging flag", 2, -1, 0),
                                    ("offset width", 2, 1, 1)):
        code = fn(tq.data_ptr(), dn.data_ptr(), pp.data_ptr(),
                  out.data_ptr(), E_MAIN, 24120, 100, vec, staged, wide,
                  torch.cuda.current_stream().cuda_stream)
        _require(code != 0, f"arrivals launcher took another {what}")
        n += 1
    return n


def _check_wait_plan(dev):
    """The library plans the wait as the wrapper does (``wait_plan``) at
    the path's level sizes, one 16-byte vector and one off, totals past
    2**31, the grid's edge and requests that cannot be planned, for
    every element size, operand count, alignment and route request, and
    its launchers
    refuse any other plan (a route taken as given, the rest
    recomputed)."""
    import ctypes
    import itertools
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.sweep.sweep import (_WAIT_ARGTYPES,
                                                 _WAIT_CHURN_ARGTYPES,
                                                 WAIT_VEC_MIN_BYTES,
                                                 wait_plan)
    LL, I = ctypes.c_longlong, ctypes.c_int
    plan_fn = _build.function("sweep", "repro_wait_plan",
                              [LL, I, I, I, I, ctypes.c_void_p])
    buf = (LL * 3)()
    totals = ([E_MAIN * L for L in (1, 308, 3837, 24120, 51529, 19690, 515)]
              + [0, 1, 7, 8, 9, 3_000_001, 2 ** 31 - 1, 2 ** 31,
                 2 ** 33 + 5, 2 ** 39 - 256, 2 ** 39 - 255])
    n = 0
    for total in totals + [WAIT_VEC_MIN_BYTES // 4 + d for d in (-1, 0)]:
        for size, ops, aligned, vector in itertools.product(
                (8, 4, 2, 3), (3, 4, 5), (True, False), (None, True, False)):
            try:
                want = tuple(int(x) for x in wait_plan(
                    total, size, ops, aligned=aligned, vector=vector))
            except ValueError:
                want = None
            code = plan_fn(total, size, ops, int(aligned),
                           -1 if vector is None else int(vector),
                           ctypes.cast(buf, ctypes.c_void_p))
            got = None if code else tuple(buf)
            _require(got == want, f"wait plan total={total} itemsize={size} "
                     f"operands={ops} aligned={aligned} vector={vector}: "
                     f"library {got}, wrapper {want}")
            n += 1
    # the launchers refuse a plan other than their own
    fn = _build.function("sweep", "repro_wait_f64", _WAIT_ARGTYPES)
    churn = _build.function("sweep", "repro_wait_churn_f64",
                            _WAIT_CHURN_ARGTYPES)
    total = E_MAIN * 24120
    x = torch.zeros(total + 2, dtype=torch.float64, device=dev)
    out = torch.empty_like(x)
    p = wait_plan(total, 8)
    _require(p.vec == 2, f"wait plan of a wide f64 level: {p}")
    st = torch.cuda.current_stream().cuda_stream
    for what, base, vec, grid in (
            ("vector width", 0, 4, p.grid),
            ("scalar grid", 0, 1, p.grid // 2),
            ("grid", 0, p.vec, p.grid + 1),
            ("vector route off 16 bytes", 8, p.vec, p.grid)):
        xa, oa = x.data_ptr() + base, out.data_ptr() + base
        code = fn(xa, xa, xa, oa, total, vec, grid, st)
        code2 = churn(xa, xa, xa, xa, oa, oa, total, vec, grid, st)
        _require(code != 0 and code2 != 0, f"wait launcher took another "
                 f"{what}")
        n += 2
    return n


def _check_arrivals_at(what, tq, dn, pp, errs):
    """The arrivals kernel each way the parent row allows (gathering;
    staging where it fits shared memory), written into NaN outputs so a
    skipped element shows, bit-equal to ``arrivals_ref``."""
    import torch
    from repro_torch.kernels.sweep import arrivals_ref
    from repro_torch.kernels.sweep.sweep import SMEM_MAX, _arrivals
    ref = arrivals_ref(tq, dn, pp)
    n = 0
    for staged in (False, True):
        if staged and tq.shape[1] * tq.element_size() > SMEM_MAX:
            continue
        got = _arrivals(tq, dn, pp, staged,
                        out=torch.full_like(dn, float("nan")))
        errs["arrivals"] = max(errs["arrivals"], _max_abs_err(got, ref))
        _require(_same(got, ref), f"arrivals {what} staged={staged}: "
                 "kernel != plain")
        n += 1
    return n


def _check_wait_at(what, own, all_in, dl, death, errs):
    """Both wait variants bit-equal to ``wait_ref``, as planned and on
    each route the operands allow (vector where they are 16-byte
    aligned, scalar), written into outputs filled with
    NaN so that a skipped element shows; returns the churn variant's
    send times as the kernel wrote them."""
    import torch
    from repro_torch.kernels.sweep import wait_ref
    from repro_torch.kernels.sweep.sweep import VEC_BYTES, _wait
    s2 = wait_ref(own, all_in, dl)
    c2, snd2 = wait_ref(own, all_in, dl, death)
    aligned = all(t.data_ptr() % VEC_BYTES == 0
                  for t in (own, all_in, dl, death))
    for vector in (None, False) + ((True,) if aligned else ()):
        how = f"{what} vector={vector}"
        s1 = _wait(own, all_in, dl, None, vector,
                   out=torch.full_like(own, float("nan")))
        c1, snd1 = _wait(own, all_in, dl, death, vector,
                         out=tuple(torch.full_like(own, float("nan"))
                                   for _ in range(2)))
        errs["wait"] = max(errs["wait"], _max_abs_err(s1, s2))
        errs["wait_churn"] = max(errs["wait_churn"], _max_abs_err(c1, c2),
                                 _max_abs_err(snd1, snd2))
        _require(_same(s1, s2), f"wait {how}: kernel != plain")
        _require(_same(c1, c2) and _same(snd1, snd2),
                 f"wait (churn variant) {how}: kernel != plain")
    return snd1


def _one_elem_in(t):
    """``t`` as a contiguous view one element into a larger tensor (off
    the 16-byte boundary: the wait's scalar route)."""
    import torch
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:].copy_(t.reshape(-1))
    return flat[1:].view(t.shape)


def _special_grid(dt, dev):
    """Every quad of {+0, -0, 0.5, +inf, -inf, NaN} as (own, all_in,
    deadline, death), (36, 36) each: the first three hold every one of
    the 216 triples, six times; each operand's NaN has bits of its own,
    so a NaN that comes out names its operand."""
    import itertools
    import torch
    bits = getattr(torch, _BITS[torch.empty(0, dtype=dt).element_size()])
    table = _SPECIALS[str(dt)]
    # +0, -0, +inf, -inf as bits; 0.5 and the NaNs set below
    half = torch.tensor(0.5, dtype=dt).view(bits).item()
    combos = torch.tensor(list(itertools.product(range(6), repeat=4)),
                          device=dev)
    ops = []
    for j in range(4):
        nan = table[4 + (j % 3)] if j < 3 else table[4]
        vals = torch.tensor([table[0], table[1], half, table[2], table[3],
                             nan], dtype=bits, device=dev)
        ops.append(vals[combos[:, j]].view(dt).reshape(36, 36))
    return ops


def _rand(shape, dt, gen, dev, specials=0.0):
    """U[0, 1) in ``dt`` (drawn in f32 for bf16, never narrowed from f64
    on the card), with a fraction ``specials`` of signed zeros,
    infinities and NaNs."""
    import torch
    f = torch.float32 if dt == torch.bfloat16 else dt
    v = torch.rand(shape, generator=gen, device=dev, dtype=f).to(dt)
    return _with_specials(v, gen, specials) if specials else v


def _check_levels(what, levels, E, dt, gen, dev, errs):
    """The arrivals and both wait kernels bit-equal to their plain
    versions at the level shapes of ``levels``, E rows, dtype ``dt``."""
    n = 0
    for d, lv in enumerate(levels):
        L = lv["vv"].shape[0]
        if d > 0:
            Lp = levels[d - 1]["vv"].shape[0]
            n += _check_arrivals_at(
                f"at {what} level {d} (E={E}, L={L}, L_prev={Lp}) {dt}",
                _rand((E, Lp), dt, gen, dev), _rand((E, L), dt, gen, dev),
                lv["par_pos"], errs)
        _check_wait_at(f"at {what} level {d} (E={E}, L={L}) {dt}",
                       *(_rand((E, L), dt, gen, dev) for _ in range(4)),
                       errs)
        n += 2
    return n


def _check_sweep(levels, gen, dev, errs):
    """Phase 2's sweep checks in f64, f32 and bf16: the arrivals kernel
    at the path's level shapes and the plan's edges (``_arrivals_cases``)
    with 2% specials in tq_prev and dn, also with dn not 16-byte aligned
    (a staged slot of one column); both wait kernels at the level shapes
    and the churn variant at its death edges."""
    import torch
    from repro_torch.kernels.sweep import wait_ref
    n = _check_arrivals_plan(dev) + _check_wait_plan(dev)
    cases = _arrivals_cases(levels, gen, dev)
    for dt in (torch.float64, torch.float32, torch.bfloat16):
        for what, E, Lp, pp in cases:
            L = pp.shape[0]
            tq = _rand((E, Lp), dt, gen, dev, 0.02)
            flat = torch.empty(E * L + 1, dtype=dt, device=dev)
            for offset in (0, 1):        # 1: dn not 16-byte aligned
                dn = flat[offset:offset + E * L].view(E, L)
                dn.copy_(_rand((E, L), dt, gen, dev, 0.02))
                n += _check_arrivals_at(f"{what} {dt} dn offset {offset}",
                                        tq, dn, pp, errs)
        # the wait at the level shapes and odd sizes (a ragged tail past
        # the last 16-byte vector), with 2% specials in every operand,
        # also as views one element in (the scalar route); and the grid
        # of every special quad
        shapes = [(E_MAIN, lv["vv"].shape[0]) for lv in levels]
        for shape in shapes + [(1, 1), (3, 7), (37, 1001)]:
            ops = [_rand(shape, dt, gen, dev, 0.02) for _ in range(4)]
            _check_wait_at(f"{shape} {dt} with specials", *ops, errs)
            _check_wait_at(f"{shape} {dt} with specials, one element in",
                           *(_one_elem_in(x) for x in ops), errs)
            n += 2
        _check_wait_at(f"every special quad {dt}", *_special_grid(dt, dev),
                       errs)
        n += 1
        for d, lv in enumerate(levels):
            L = lv["vv"].shape[0]
            own, all_in, dl, death = (_rand((E_MAIN, L), dt, gen, dev)
                                      for _ in range(4))
            _check_wait_at(f"level {d} {dt}", own, all_in, dl, death, errs)
            # the churn variant's edges: deaths exactly at the send time
            # (alive, by ``>=``), infinite deaths, an all-dead row (0),
            # an all-alive row (1) and a row dead exactly at s (2)
            s = wait_ref(own, all_in, dl)
            u = torch.rand((E_MAIN, L), generator=gen, device=dev)
            edge = torch.where(u < 0.4, s, torch.where(
                u < 0.6, torch.full_like(s, math.inf), death))
            edge[0] = -1.0
            edge[1] = math.inf
            edge[2] = s[2]
            snd = _check_wait_at(f"level {d} {dt} at the death edges", own,
                                 all_in, dl, edge, errs)
            _require(bool(torch.isinf(snd[0]).all())
                     and _same(snd[1:3], s[1:3]),
                     f"wait (churn variant) level {d} {dt}: a peer dead "
                     "exactly at its send time must send")
            n += 4
    return n


_METRICS = ("n_reached", "n_edges_pq", "avg_degree", "m_fw", "b_fw", "m_bw",
            "m_rt", "b_bw", "b_rt", "response_time_s", "accuracy")


def _require_same_result(what, rg, rc, other="CPU path"):
    """Two TopKResults with equal values, indices and metrics bits."""
    import numpy as np
    for f in _METRICS:
        _require(np.array_equal(getattr(rg.metrics, f),
                                getattr(rc.metrics, f)),
                 f"{what}: card != {other} on metric {f}")
    _require(rg.values.dtype == rc.values.dtype
             and np.array_equal(rg.values, rc.values)
             and np.array_equal(rg.indices, rc.indices),
             f"{what}: card != {other} on values / indices")


# ---------------------------------------------------------------------------
# phase 3: the main path through the QueryServer
# ---------------------------------------------------------------------------

def _serve(engine, _build):
    from repro_torch.engine import QueryServer, QuerySpec, ServerConfig
    server = QueryServer(engine, ServerConfig(max_queue=256, max_batch=64))
    pool = (0, 1)
    t0 = time.perf_counter()
    for o in pool:
        server.warm(QuerySpec(origins=(o,), rng="independent"),
                    "fd-dynamic", batch_sizes=(1, E_MAIN))
    for pol in ("fd-basic", "fd-st1", "fd-st1+2"):
        server.warm(QuerySpec(origins=(0,)), pol)
    print(f"[main] warmed in {time.perf_counter() - t0:.3f} s")
    results, errors = [], []
    lock = threading.Lock()

    def client(c):
        try:
            for j in range(4):
                i = 4 * c + j
                h = server.submit(QuerySpec(origins=(pool[i % 2],),
                                            seed=1000 + i,
                                            rng="independent"),
                                  "fd-dynamic")
                res = h.result(timeout=600)
                with lock:
                    results.append(("fd-dynamic", res))
        except Exception as e:           # noqa: BLE001 — reported below
            with lock:
                errors.append(repr(e))

    _build.reset_launches()              # count the main path alone
    t0 = time.perf_counter()
    server.start()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    for t in threads:
        t.start()
    singles = [(pol, server.submit(QuerySpec(origins=(0,), seed=77), pol))
               for pol in ("fd-basic", "fd-st1", "fd-st1+2")]
    for pol, h in singles:
        try:
            results.append((pol, h.result(timeout=600)))
        except Exception as e:           # noqa: BLE001 — reported below
            errors.append(repr(e))
    for t in threads:
        t.join(timeout=900)
    alive = [t for t in threads if t.is_alive()]
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    # the load's own percentiles: the fd-stats request below holds the
    # one dispatcher for seconds of host work and is timed apart
    m = server.metrics()
    print(f"[main] served {m.served}/{m.submitted} in {wall:.3f} s; "
          f"failed={m.failed} shed={m.shed} timed_out={m.timed_out}")
    print("[main] serving metrics " + json.dumps(m.as_dict()))
    print("[main] launches " + json.dumps(launches))
    # the two-round statistics heuristic, served from the same queue
    # once the load has drained
    stats = None
    if not alive:
        t1 = time.perf_counter()
        try:
            stats = server.submit(QuerySpec(**STATS_SPEC_ARGS),
                                  "fd-stats").result(timeout=900)
        except Exception as e:           # noqa: BLE001 — reported below
            errors.append(repr(e))
        print(f"[fd-stats] submit to result {time.perf_counter() - t1:.3f}"
              " s on the drained server")
    server.stop(drain=not alive, timeout=60)
    _require(not alive, "client threads did not finish")
    _require(not errors, f"requests failed: {errors}")
    _require(m.submitted == 35 and m.served == m.submitted,
             f"served {m.served} of {m.submitted} (expected 35)")
    m_all = server.metrics()
    _require(m_all.submitted == 36 and m_all.served == m_all.submitted,
             f"with fd-stats: served {m_all.served} of {m_all.submitted} "
             "(expected 36)")
    _require(m_all.failed == 0,
             f"{m_all.failed} requests failed in the engine")
    for pol, res in results:
        _check_result(pol, res, engine.params.k)
        _require(res.compile_s == 0.0,
                 f"{pol}: live dispatch compiled ({res.compile_s} s)")
    for name in ("merge", "arrivals", "wait"):
        _require(launches[name] > 0, f"kernel {name} never launched on "
                 "the main path")
    _check_stats(engine, stats)
    return launches, m


# the fd-stats request of phase 3: one origin x one trial
STATS_SPEC_ARGS = {"origins": (0,), "seed": 79}


def _check_stats(engine, served):
    """The served fd-stats answer: from the host reference path, traffic
    cut, and equal to a direct ``engine.run`` of the same request."""
    import numpy as np
    from repro_torch.engine import QuerySpec
    ex = served.extras
    print(f"[fd-stats] served in {served.run_s:.3f} s (host run_s), "
          f"queue {served.queue_s:.3f} s: comm_reduction "
          f"{ex['comm_reduction']}, accuracy {ex['accuracy']}, bytes "
          f"{ex['metrics_full'].total_bytes} -> "
          f"{ex['metrics_pruned'].total_bytes}")
    _require(served.backend_used == "sim" and served.backend == "sim-torch",
             f"fd-stats: backend_used={served.backend_used}")
    _require(ex["comm_reduction"] > 0,
             f"fd-stats cut no traffic: {ex['comm_reduction']}")
    t0 = time.perf_counter()
    direct = engine.run(QuerySpec(**STATS_SPEC_ARGS), "fd-stats")
    print(f"[fd-stats] direct engine.run in {time.perf_counter() - t0:.3f}"
          f" s wall (run_s {direct.run_s:.3f} s)")
    for key in ("metrics_full", "metrics_pruned", "comm_reduction",
                "accuracy"):
        _require(ex[key] == direct.extras[key],
                 f"fd-stats: served {key} != direct engine.run")
    for f in _METRICS:
        _require(np.array_equal(getattr(served.metrics, f),
                                getattr(direct.metrics, f)),
                 f"fd-stats: served metric {f} != direct engine.run")


# ---------------------------------------------------------------------------
# phase 3b: churn and the CN / CN* baselines through a second QueryServer
# ---------------------------------------------------------------------------

# the reference's full-size churn suite (benchmarks/multi_query.py,
# jax_churn_bench): heavy and light churn
CHURN_HEAVY_S = 60.0
CHURN_LIGHT_S = 600.0


def _check_result(name, res, k):
    """One served answer: the port's backend, a descending k-list of
    scores in (0, 1], accuracies in [0, 1]."""
    _require(res.backend_used == res.backend == "sim-torch",
             f"{name}: backend_used={res.backend_used}")
    v = res.values
    _require(v.shape == (1, 1, k)
             and bool((v[..., :-1] >= v[..., 1:]).all())
             and bool((v > 0).all() and (v <= 1).all()),
             f"{name}: values not a descending score list: {v}")
    acc = res.metrics.accuracy
    _require(bool(((acc >= 0) & (acc <= 1)).all()),
             f"{name}: accuracy out of range {acc}")


def _serve_churn(engine, _build):
    """Serve churned fd-dynamic (with §4.2 reroute), fd-basic under
    churn, cn and cn-star (with and without churn) from 4 clients."""
    from repro_torch.engine import (QueryServer, QuerySpec, ServerConfig,
                                    get_policy)
    heavy = get_policy("fd-dynamic").variant(lifetime_mean_s=CHURN_HEAVY_S)
    light = get_policy("fd-dynamic").variant(lifetime_mean_s=CHURN_LIGHT_S)
    singles = {
        "fd-basic@60": get_policy("fd-basic").variant(
            lifetime_mean_s=CHURN_HEAVY_S),
        "cn": get_policy("cn"),
        "cn-star": get_policy("cn-star"),
        "cn@60": get_policy("cn").variant(lifetime_mean_s=CHURN_HEAVY_S),
    }
    server = QueryServer(engine, ServerConfig(max_queue=256, max_batch=64))
    pool = (0, 1)
    t0 = time.perf_counter()
    for o in pool:
        server.warm(QuerySpec(origins=(o,), rng="independent"), heavy,
                    batch_sizes=(1, 4))
        server.warm(QuerySpec(origins=(o,), rng="independent"), light,
                    batch_sizes=(1,))
    for pol in singles.values():
        server.warm(QuerySpec(origins=(0,)), pol, batch_sizes=(1,))
    print(f"[churn] warmed in {time.perf_counter() - t0:.3f} s")
    stream = ([("fd-dynamic@60", heavy)] * 8
              + [("fd-dynamic@600", light)] * 2)
    results, errors = [], []
    lock = threading.Lock()

    def client(c):
        try:
            for i in range(c, len(stream), 4):
                name, pol = stream[i]
                h = server.submit(QuerySpec(origins=(pool[i % 2],),
                                            seed=2000 + i,
                                            rng="independent"), pol)
                res = h.result(timeout=600)
                with lock:
                    results.append((name, res))
        except Exception as e:           # noqa: BLE001 — reported below
            with lock:
                errors.append(repr(e))

    _build.reset_launches()              # count this path alone
    t0 = time.perf_counter()
    server.start()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    handles = [(name, server.submit(QuerySpec(origins=(0,), seed=78), pol))
               for name, pol in singles.items()]
    for name, h in handles:
        try:
            results.append((name, h.result(timeout=600)))
        except Exception as e:           # noqa: BLE001 — reported below
            errors.append(repr(e))
    for t in threads:
        t.join(timeout=900)
    alive = [t for t in threads if t.is_alive()]
    server.stop(drain=not alive, timeout=60)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    m = server.metrics()
    print(f"[churn] served {m.served}/{m.submitted} in {wall:.3f} s; "
          f"failed={m.failed} shed={m.shed} timed_out={m.timed_out}")
    print("[churn] serving metrics " + json.dumps(m.as_dict()))
    print("[churn] launches " + json.dumps(launches))
    _require(not alive, "client threads did not finish")
    _require(not errors, f"requests failed: {errors}")
    n_req = len(stream) + len(singles)
    _require(m.submitted == n_req and m.served == m.submitted,
             f"served {m.served} of {m.submitted} (expected {n_req})")
    _require(m.failed == 0, f"{m.failed} requests failed in the engine")
    run_s, dead = {}, {}
    for name, res in results:
        _check_result(name, res, engine.params.k)
        _require(res.compile_s == 0.0,
                 f"{name}: live dispatch compiled ({res.compile_s} s)")
        run_s.setdefault(name, []).append(res.run_s)
        # fd-basic and cn send one list per peer alive at its send
        # time: fewer lists than reached peers means some died
        short = int((res.metrics.n_reached - 1 - res.metrics.m_bw).min())
        dead[name] = max(dead.get(name, short), short)
    print("[churn] host run_s by policy " + json.dumps(run_s))
    print("[churn] reached - 1 - lists sent, by policy " + json.dumps(dead))
    lat = m.latency
    print(f"[churn] served latency p50 {lat.p50_s} s, p95 {lat.p95_s} s, "
          f"p99 {lat.p99_s} s")
    _require(dead["fd-basic@60"] > 0 and dead["cn@60"] > 0,
             "no peer died at its send time at lifetime 60")
    for name in ("wait_churn", "merge", "arrivals"):
        _require(launches[name] > 0, f"kernel {name} never launched on "
                 "the churn path")
    return launches, m


# ---------------------------------------------------------------------------
# phase 4: the card against the port's CPU path
# ---------------------------------------------------------------------------

def _parity(engine, p):
    """4-entry specs (static and churned fd-dynamic, cn, cn-star) on the
    card and on the port's CPU path: equal bits."""
    from repro_torch.engine import QuerySpec, SimEngine, get_policy
    spec = QuerySpec(origins=(0, 1), n_trials=2, rng="independent")
    cpu = SimEngine(engine.plan, p, device="cpu")
    for name, pol in (
            ("fd-dynamic", "fd-dynamic"),
            ("fd-dynamic@60", get_policy("fd-dynamic").variant(
                lifetime_mean_s=CHURN_HEAVY_S)),
            ("cn", "cn"), ("cn-star", "cn-star")):
        t0 = time.perf_counter()
        rg = engine.run(spec, pol)
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        rc = cpu.run(spec, pol)
        t_cpu = time.perf_counter() - t0
        _require_same_result(name, rg, rc)
        print(f"[parity] {name} 4-entry spec: card == CPU path bit for "
              f"bit (card {t_card:.3f} s, CPU {t_cpu:.3f} s host wall)")


# ---------------------------------------------------------------------------
# phase 5: the DeviceEngine's FD collectives over 64 virtual peers
# ---------------------------------------------------------------------------

SCHEDULES = ("halving", "doubling", "ring")


def _check_answer(name, res, scores, n):
    """A k-list of the query: shape, descending, finite, indices in
    range and pointing at their scores."""
    import torch
    v, i = res.values, res.indices
    _require(v.shape == (DEV_K,) and i.dtype == torch.int32
             and bool(torch.isfinite(v).all())
             and bool((v[:-1] >= v[1:]).all())
             and bool(((i >= 0) & (i < n)).all())
             and _same(scores[i.long()], v),
             f"{name}: not the descending top-k of its scores")


def _device_path(dev, gen, _build):
    """Drive the DeviceEngine at full size; return the launches of this
    path, the scores and the seconds per call."""
    import torch
    from repro_torch import DeviceEngine, make_mesh
    from repro_torch.engine import QuerySpec
    n = DEV_PEERS * DEV_LOCAL
    t0 = time.perf_counter()
    scores = torch.randn((DEV_B, n), generator=gen, device=dev)
    rows = torch.randn((n, DEV_D), generator=gen, device=dev)
    mesh = make_mesh((DEV_PEERS,), ("model",))
    torch.cuda.synchronize()
    print(f"[device] {DEV_B} queries x N={n} f32 scores "
          f"({scores.numel() * 4} bytes), rows ({n}, {DEV_D}) f32, "
          f"{mesh}, k={DEV_K}; made in {time.perf_counter() - t0:.3f} s")
    spec = QuerySpec(k=DEV_K)
    reqs = list(scores)                  # 32 one-dimensional requests
    runs = [(sch, "fd-dynamic", DeviceEngine(mesh, schedule=sch))
            for sch in SCHEDULES]
    cn_eng = DeviceEngine(mesh)
    runs += [("-", "cn", cn_eng), ("-", "cn-star", cn_eng)]
    out, timings = {}, {}
    _build.reset_launches()              # count this path alone
    for sch, pol, eng in runs:
        for rep in range(2):             # the first call builds the plan
            res = eng.run_many([spec] * DEV_B, pol, scores=reqs)
            got = (eng.run(spec, pol, scores=scores, rows=rows)
                   if pol == "fd-dynamic" else None)
            timings[f"{pol}/{sch}/run_many#{rep}"] = res[0].run_s
            if got is not None:
                timings[f"{pol}/{sch}/gather#{rep}"] = got.run_s
        out[(sch, pol)] = (res, got)
    # above the tile route's k: the select route, 4 stacked queries
    large_spec = QuerySpec(k=DEV_K_LARGE)
    large = runs[0][2].run_many([large_spec] * 4, "fd-dynamic",
                                scores=reqs[:4])
    timings[f"fd-dynamic/halving/run_many k={DEV_K_LARGE}"] = large[0].run_s
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print("[device] launches " + json.dumps(launches))
    print("[device] run_s " + json.dumps(timings))
    for name in ("topk", "topk_select", "merge"):
        _require(launches[name] > 0, f"kernel {name} never launched on "
                 "the device path")
    first = out[("halving", "fd-dynamic")][0]
    for (sch, pol), (res, got) in out.items():
        _require(len(res) == DEV_B and all(
            r.batch_size == DEV_B and r.backend == "device-torch"
            for r in res), f"{pol}/{sch}: requests were not stacked")
        for b, r in enumerate(res):
            _check_answer(f"{pol}/{sch} query {b}", r, scores[b], n)
            # normal scores do not tie: every algorithm finds the same
            _require(_same(r.indices, first[b].indices),
                     f"{pol}/{sch} query {b}: other winners than halving")
        if got is not None:
            _require(_same(got.indices, torch.stack(
                [r.indices for r in res]))
                and _same(got.rows, rows[got.indices.long()]),
                f"{pol}/{sch}: gather rows are not the winners' rows")

    # the first 4 queries on the port's CPU path, bit for bit
    cpu = make_mesh((DEV_PEERS,), ("model",), device="cpu")
    s4, rows_cpu = scores[:4].cpu(), rows.cpu()
    t0 = time.perf_counter()
    for (sch, pol), (res, got) in out.items():
        eng = DeviceEngine(cpu, schedule="halving" if sch == "-" else sch)
        ref = eng.run_many([spec] * 4, pol, scores=list(s4))
        for b in range(4):
            _require(_same(res[b].values.cpu(), ref[b].values)
                     and _same(res[b].indices.cpu(), ref[b].indices),
                     f"{pol}/{sch} query {b}: card != CPU path")
        if got is not None:
            g = eng.run(spec, pol, scores=s4, rows=rows_cpu)
            _require(_same(got.values[:4].cpu(), g.values)
                     and _same(got.indices[:4].cpu(), g.indices)
                     and _same(got.rows[:4].cpu(), g.rows),
                     f"{pol}/{sch} gather: card != CPU path")
    ref = DeviceEngine(cpu, schedule="halving").run_many(
        [large_spec] * 4, "fd-dynamic", scores=list(s4))
    for b in range(4):
        v, i = large[b].values, large[b].indices
        _require(large[b].batch_size == 4 and v.shape == (DEV_K_LARGE,)
                 and bool((v[:-1] >= v[1:]).all())
                 and _same(scores[b][i.long()], v),
                 f"fd-dynamic/halving k={DEV_K_LARGE} query {b}: not the "
                 "descending top-k of its scores, or not stacked")
        _require(_same(v.cpu(), ref[b].values)
                 and _same(i.cpu(), ref[b].indices),
                 f"fd-dynamic/halving k={DEV_K_LARGE} query {b}: card != "
                 "CPU path")
    print(f"[device] 5 algorithms x {DEV_B} queries: answers checked; "
          f"first 4 queries == CPU path bit for bit, and 4 at "
          f"k={DEV_K_LARGE} (CPU "
          f"{time.perf_counter() - t0:.3f} s)")
    return launches, scores, timings


# ---------------------------------------------------------------------------
# the sweep kernels at a path's own level shapes
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 7: every registered topology family, with per-edge latencies
# ---------------------------------------------------------------------------

# the reference's full-size topology_sweep (benchmarks/multi_query.py)
TOPO_FLAT = 20_000
TOPO_SIZES = {"hierarchical": 100_000, "waxman": 2_000}


def _topologies(dev, gen, errs, _build):
    """Each family of ``available_topologies()`` (seed 7) under its
    native latency model: ``fd-dynamic``, origins (0, 1) x 2 independent
    trials on the card, equal bits on the port's CPU path."""
    import torch
    from repro_torch.engine import NetworkPlan, QuerySpec, SimEngine
    from repro_torch.engine.sim_torch import _device_slices
    from repro_torch.p2psim import (SimParams, available_topologies,
                                    build_topology)
    spec = QuerySpec(origins=(0, 1), n_trials=2, seed=5, rng="independent")
    fams, n_chk = {}, 0
    for name in available_topologies():
        n = TOPO_SIZES.get(name, TOPO_FLAT)
        t0 = time.perf_counter()
        top = build_topology(name, n, seed=7)
        build_s = time.perf_counter() - t0
        lm = "edge" if top.coords is not None else "iid"
        p = SimParams(seed=5, latency_model=lm)
        plan = NetworkPlan(top)
        card = SimEngine(plan, p)
        t0 = time.perf_counter()
        card.run(spec)                   # statics, slices, uploads
        warm_s = time.perf_counter() - t0
        st = plan.origin_statics([0], p.ttl, "st1+2")[0][0]
        levels = _device_slices(plan.depth_slices(st), dev)[0]
        n_chk += _check_levels(name, levels, 2, torch.float64, gen, dev,
                               errs)
        widths = [len(lv["vv"]) for lv in levels]
        fams[name] = (top, plan, p, card, build_s, warm_s,
                      f"depth {len(widths) - 1}, widest level "
                      f"{max(widths)}")
    _build.reset_launches()              # count this path alone
    runs = {name: f[3].run(spec) for name, f in fams.items()}
    launches = dict(_build.LAUNCHES)
    print("[topologies] launches " + json.dumps(launches))
    for name, (top, plan, p, card, build_s, warm_s, lv) in fams.items():
        rg = runs[name]
        t0 = time.perf_counter()
        rc = SimEngine(plan, p, device="cpu").run(spec)
        cpu_s = time.perf_counter() - t0
        _require(rg.backend_used == "sim-torch" and rg.topology == name
                 and rg.latency_model == p.latency_model,
                 f"{name}: result fields {rg.backend_used} {rg.topology} "
                 f"{rg.latency_model}")
        _require_same_result(f"topology {name}", rg, rc)
        print(f"[topologies] {name} n={top.n} edges={top.n_edges} "
              f"latency={p.latency_model} ({lv}): built in "
              f"{build_s:.3f} s, first run {warm_s:.3f} s, card run_s "
              f"{rg.run_s:.6f} s, CPU path {cpu_s:.3f} s; card == CPU bit "
              f"for bit; mean m_bw {float(rg.metrics.m_bw.mean())}, mean "
              f"response {float(rg.metrics.response_time_s.mean())} s")
    for name in ("merge", "arrivals", "wait"):
        _require(launches[name] > 0, f"kernel {name} never launched on "
                 "the topology path")
    print(f"[topologies] {len(fams)} families; {n_chk} kernel checks at "
          "their level shapes bit-equal to the plain versions")
    return launches


# ---------------------------------------------------------------------------
# phase 8: reduced precision (f32 / bf16) on the sim path
# ---------------------------------------------------------------------------

def _star(n):
    """A star of ``n`` peers (1M spokes share one neighbour array), the
    reference's precision_scale overlay."""
    import numpy as np
    from repro_torch.p2psim import Topology
    hub = np.arange(1, n, dtype=np.int32)
    spoke = np.array([0], dtype=np.int32)
    return Topology(n=n, neighbors=[hub] + [spoke] * (n - 1), kind="star")


def _check_cast(prec, lo, hi, what=None):
    """Checks of a reduced answer ``lo`` against the f64 answer ``hi``
    of the same spec that still tell selections apart where the top
    scores tie once cast (the tolerance contract then cannot): the cast
    is monotone, so (1) an owner in both answers holds in ``lo`` the
    cast of its own leading f64 scores, in order, and (2) an entry whose
    message, byte and reach counts equal f64's (no late or urgent
    decision flipped) has the f64 values cast, rank by rank."""
    import numpy as np
    from repro_torch.engine.precision import host_cast
    what = what or prec
    k = hi.values.shape[-1]
    v_lo, o_lo = lo.values.reshape(-1, k), lo.indices.reshape(-1, k)
    v_hi, o_hi = hi.values.reshape(-1, k), hi.indices.reshape(-1, k)
    cast = host_cast(v_hi, prec).double().numpy()
    owners = slots = 0
    for e in range(len(v_hi)):
        for o in np.intersect1d(o_lo[e][o_lo[e] >= 0], o_hi[e]):
            a, b = v_lo[e][o_lo[e] == o], cast[e][o_hi[e] == o]
            m = min(len(a), len(b))
            _require(np.array_equal(a[:m], b[:m]), f"{what} entry {e} "
                     f"owner {o}: values {a[:m]} != its f64 values cast "
                     f"{b[:m]}")
            owners, slots = owners + 1, slots + m
    same = np.ones(len(v_hi), bool)
    for f in ("n_reached", "m_fw", "m_bw", "b_fw", "b_bw", "m_rt", "b_rt"):
        same &= (np.asarray(getattr(lo.metrics, f)).reshape(-1)
                 == np.asarray(getattr(hi.metrics, f)).reshape(-1))
    for e in np.flatnonzero(same):
        _require(np.array_equal(v_lo[e], cast[e]), f"{what} entry {e} "
                 "(no decision flipped): values != the f64 values cast")
    distinct = [len(np.unique(c)) for c in cast]
    tied = max(distinct) == 1
    print(f"[precision] {what} cast checks: {owners} shared owners "
          f"({slots} slots) hold their f64 values cast; "
          f"{int(same.sum())}/{len(same)} entries without a flipped "
          f"decision equal the f64 values cast; the f64 top-{k} casts to "
          f"{distinct} distinct values an entry"
          + ("; every entry's top-k ties once cast, so the tolerance "
             "contract and check (2) cannot tell selections apart here"
             if tied else ""))
    return owners, tied


def _reduced_precision(engine, dev, gen, errs, _build):
    """The reference's precision suite on the phase-3 overlay: f32 and
    bf16 validated against the f64 rerun and held to the f64 answer
    cast (``_check_cast``), card == CPU bits on 4-entry static, churned
    and cn specs, warm run_s per precision; then the 1M-peer star (int32
    plan, f32).  Launches are counted per precision, over the reduced
    runs alone (no validation, no f64 run inside a counted window)."""
    import torch
    from repro_torch.engine import (NetworkPlan, QuerySpec, SimEngine,
                                    get_policy)
    from repro_torch.engine.sim_torch import _device_slices
    from repro_torch.p2psim import SimParams, barabasi_albert
    plan, p = engine.plan, engine.params
    spec = QuerySpec(origins=(0, 1), n_trials=2, seed=5, rng="independent")
    churn = get_policy("fd-dynamic").variant(lifetime_mean_s=CHURN_HEAVY_S)
    reduced = ("f32", "bf16")
    timed = {"f64": SimEngine(plan, p)}
    for prec in reduced:
        timed[prec] = SimEngine(plan, p, precision=prec,
                                validate_precision=False)
        for pol in ("fd-dynamic", churn, "cn"):
            timed[prec].run(spec, pol)   # first run books its uploads
    counts = {prec: dict.fromkeys(_build.LAUNCHES, 0) for prec in reduced}

    def counted(prec, fn):
        _build.reset_launches()
        out = fn()
        for name, c in _build.LAUNCHES.items():
            counts[prec][name] += c
        return out

    run_s, last = {prec: math.inf for prec in timed}, {}
    for _ in range(3):                   # in turns: f64, f32, bf16
        for prec, eng in timed.items():
            last[prec] = (eng.run(spec) if prec == "f64" else
                          counted(prec, lambda: eng.run(spec)))
            run_s[prec] = min(run_s[prec], last[prec].run_s)
    for prec in reduced:
        tol = SimEngine(plan, p, precision=prec).run(spec).extras[
            "tolerance"]
        print(f"[precision] {prec} tolerance {json.dumps(tol)}")
        _require(tol["ok"], f"{prec} tolerance contract violated: {tol}")
        if tol["separated"]:
            _require(tol["recall"] == 1.0, f"{prec}: separated scores "
                     f"but recall {tol['recall']}")
        _check_cast(prec, last[prec], last["f64"])
        cpu = SimEngine(plan, p, device="cpu", precision=prec,
                        validate_precision=False)
        for name, pol in (("fd-dynamic", "fd-dynamic"),
                          ("fd-dynamic@60", churn), ("cn", "cn")):
            rg = counted(prec, lambda: timed[prec].run(spec, pol))
            _require(rg.precision == prec, f"{name}: ran in {rg.precision}")
            t0 = time.perf_counter()
            rc = cpu.run(spec, pol)
            _require_same_result(f"{prec} {name}", rg, rc)
            print(f"[precision] {prec} {name} 4-entry spec: card == CPU "
                  f"path bit for bit (CPU {time.perf_counter() - t0:.3f} s)")
    print("[precision] warm run_s (min of 3 in turns, no validation) "
          + json.dumps(run_s))
    # the same checks where the top scores stay apart once cast: one
    # score a peer, on the phase-3 overlay in f32 and, for bf16's 8
    # bits, on a small BA overlay
    one = dataclasses.replace(p, tuples_lo=1, tuples_hi=1)
    small = NetworkPlan(barabasi_albert(SPREAD_PEERS, m=2, seed=7))
    for prec, pl in (("f32", plan), ("bf16", small)):
        what = f"{prec}, n={pl.top.n}, one score a peer"
        lo = SimEngine(pl, one, precision=prec).run(spec)
        tol = lo.extras["tolerance"]
        print(f"[precision] {what}: tolerance {json.dumps(tol)}")
        _require(tol["ok"], f"{what}: tolerance contract violated: {tol}")
        owners, tied = _check_cast(prec, lo, SimEngine(pl, one).run(spec),
                                   what)
        _require(owners > 0 and not tied, f"{what}: the top scores tie "
                 "once cast; the cast checks tell nothing apart")
    # the 1M-peer star: the widest level the sweep sees, int32 indices
    t0 = time.perf_counter()
    plan1m = NetworkPlan(_star(STAR_PEERS), index_dtype="int32")
    build_s = time.perf_counter() - t0
    _require(str(plan1m.index_dtype) == "int32"
             and str(plan1m.edge_keys.dtype) == "int64",
             f"star plan dtypes {plan1m.index_dtype} "
             f"{plan1m.edge_keys.dtype}")
    star_p, star_q = SimParams(seed=3), QuerySpec(origins=(0,), seed=3)
    star = SimEngine(plan1m, star_p, precision="f32",
                     validate_precision=False)
    t0 = time.perf_counter()
    counted("f32", lambda: star.run(star_q))
    first_s = time.perf_counter() - t0
    res = counted("f32", lambda: star.run(star_q))
    tol = SimEngine(plan1m, star_p, precision="f32").run(star_q).extras[
        "tolerance"]
    print(f"[precision] star n={STAR_PEERS} int32 plan built in "
          f"{build_s:.3f} s; f32 first run {first_s:.3f} s, run_s "
          f"{res.run_s:.6f} s; tolerance {json.dumps(tol)}")
    _require(tol["ok"], f"1M-peer f32 tolerance contract violated: {tol}")
    _check_cast("f32", res, SimEngine(plan1m, star_p).run(star_q))
    print("[precision] launches " + json.dumps(counts))
    for prec in reduced:
        for name in ("merge", "arrivals", "wait", "wait_churn"):
            _require(counts[prec][name] > 0, f"kernel {name} never "
                     f"launched on the {prec} path")
    st = plan1m.origin_statics([0], 0, "st1+2")[0][0]
    levels = _device_slices(plan1m.depth_slices(st), dev)[0]
    n = _check_levels("star", levels, 1, torch.float32, gen, dev, errs)
    print(f"[precision] {n} kernel checks at the star's level shapes "
          "bit-equal to the plain versions")
    return {f"precision_{prec}": c for prec, c in counts.items()}, run_s


STAR_PEERS = 1_000_000
SPREAD_PEERS = 2_000


# ---------------------------------------------------------------------------
# phase 9: a live overlay, peers joining and leaving between queries
# ---------------------------------------------------------------------------

# the reference's full-size live-overlay workload (benchmarks/
# overlay_dynamics.py, incremental_sync_rows and churn_sweep_rows): a
# hierarchical overlay of 100,000 peers, seed 7, SimParams(seed=0),
# cached origins drawn by default_rng(11); one leave (a deep leaf,
# "reconnect" repair), one join, then a random session of 32 events
# between syncs, here on one overlay.  Cut to fit the call's time: a hot
# set of 4 origins (the reference's 16) and one session (its 2, 8 and
# 32)
OV_PEERS = 100_000
OV_ORIGINS = 4
OV_SESSIONS = (32,)
# how many of the hot set also get a churned request (phase 3b's heavy
# churn, lifetime 60 s; 2 of 4 here, 4 of 16 before the cut), and
# overlay_dynamics._parity's lifetime
OV_CHURN_ORIGINS = 2
OV_PARITY_LIFETIME_S = 30.0


def _deep_leaf(plan, origin):
    """A degree-1 peer as deep as possible below ``origin``
    (overlay_dynamics._deep_leaf)."""
    import numpy as np
    from repro_torch.p2psim.graph import bfs_tree_csr
    _, depth, _ = bfs_tree_csr(plan.indptr, plan.indices, origin,
                               plan.top.n)
    cand = np.where(plan.degrees == 1, depth, -1)
    if cand.max() < 1:
        cand = np.where(plan.degrees <= 2, depth, -1)
    return int(cand.argmax())


def _warm_hot_set(engine, origins):
    """Statics and depth slices of ``origins`` (what a standing server
    holds for its hot set), then their device upload; returns the host
    seconds and the upload seconds."""
    import numpy as np
    import torch
    from repro_torch.engine.sim_torch import _device_slices
    plan = engine.plan
    t0 = time.perf_counter()
    sts, _ = plan.origin_statics(np.asarray(origins, np.int64), 0, "st1+2")
    sls = [plan.depth_slices(st) for st in sts]
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for sl in sls:
        _device_slices(sl, engine.device)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return host_s, time.perf_counter() - t0


def _overlay_requests(origins, i, tomb):
    """Event ``i``'s requests: fd-dynamic on independent streams over the
    hot set, ``OV_CHURN_ORIGINS`` of them at lifetime 60 s, one
    fd-st1+2 and, where a peer has left, one fd-dynamic request from
    it."""
    from repro_torch.engine import QuerySpec, get_policy
    churn = get_policy("fd-dynamic").variant(lifetime_mean_s=CHURN_HEAVY_S)
    seed = 3000 + 100 * i
    reqs = [(f"fd-dynamic@{o}", QuerySpec(origins=(o,), seed=seed + j,
                                          rng="independent"), "fd-dynamic")
            for j, o in enumerate(origins)]
    reqs += [(f"fd-dynamic@60@{o}", QuerySpec(origins=(o,), seed=seed + 50
                                              + j, rng="independent"), churn)
             for j, o in enumerate(origins[:OV_CHURN_ORIGINS])]
    reqs.append((f"fd-st1+2@{origins[0]}",
                 QuerySpec(origins=(origins[0],), seed=seed + 90),
                 "fd-st1+2"))
    if tomb is not None:
        reqs.append((f"fd-dynamic@{tomb} (departed)",
                     QuerySpec(origins=(tomb,), seed=seed + 99,
                               rng="independent"), "fd-dynamic"))
    return reqs


def _check_reference(engine, origin, ref):
    """A shared batch-of-1 at ``origin`` equals ``ref``, the scalar
    reference run on the overlay as it stands (overlay_dynamics._parity;
    :func:`_overlay_cpu` runs it)."""
    from repro_torch.engine import QuerySpec, get_policy
    t0 = time.perf_counter()
    one = engine.run(QuerySpec(origins=(origin,)), get_policy(
        "fd-dynamic").variant(lifetime_mean_s=OV_PARITY_LIFETIME_S))
    _require(one.query_metrics(0, 0) == ref, f"origin {origin}: the "
             "synced plan's answer != run_query_reference")
    return time.perf_counter() - t0


def _overlay_events():
    """Phase 9's events: (name, session size or None)."""
    return [("leave", None), ("join", None)] + [
        (f"session {m}", m) for m in OV_SESSIONS]


def _overlay_event(ov, plan, origins, i, event, m, tomb):
    """Event ``i`` applied to ``ov``: a deep leaf below origin 0 leaves
    ("reconnect" repair), a peer joins beside origin 0, or a random
    session of ``m`` events; returns the last departed peer."""
    from repro_torch.engine import apply_events, random_session
    if event == "leave":
        tomb = _deep_leaf(plan, origins[0])
        ov.remove_peer(tomb, repair="reconnect")
    elif event == "join":
        ov.add_peer(neighbors=(origins[0],
                               int(ov.top.neighbors[origins[0]][0])))
    else:
        evs = random_session(ov, m, seed=100 + i - 2, join_prob=0.5)
        apply_events(ov, evs, repair="reconnect")
        tomb = next((e.peer for e in reversed(evs)
                     if e.kind == "leave"), tomb)
    return tomb


def _plan_digest(plan):
    """A digest of a plan's graph (its CSR and degrees)."""
    import hashlib
    import numpy as np
    h = hashlib.sha256()
    for a in (plan.indptr, plan.indices, plan.degrees):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _slim(res):
    """What :func:`_require_same_result` compares of a result."""
    from types import SimpleNamespace
    return SimpleNamespace(
        values=res.values, indices=res.indices,
        metrics=SimpleNamespace(**{f: getattr(res.metrics, f)
                                   for f in _METRICS}))


def _overlay_cpu(out, n_peers, origins):
    """Phase 9's CPU path, in a process of its own beside the card's
    work: the same overlay of ``n_peers`` and hot set ``origins``, the
    same events each followed
    by an incremental ``plan.sync()``, each event's requests on the
    port's CPU path over the synced plan and, at the first and the last
    event, origin 0's ``run_query_reference``; one record an event on
    the queue ``out`` (an exception's text in place of the records)."""
    try:
        import os
        import torch
        from repro_torch.engine import Overlay, SimEngine
        from repro_torch.p2psim import (SimParams, build_topology,
                                        run_query_reference)
        # two cores left to the process that drives the card
        torch.set_num_threads(max(1, (os.cpu_count() or 1) - 2))
        ov = Overlay(build_topology("hierarchical", n_peers, seed=7))
        p = SimParams(seed=0)
        cpu = SimEngine(ov, p, device="cpu")
        plan = cpu.plan
        _warm_hot_set(cpu, origins)
        events = _overlay_events()
        tomb = None
        for i, (event, m) in enumerate(events):
            tomb = _overlay_event(ov, plan, origins, i, event, m, tomb)
            plan.sync()
            reqs = _overlay_requests(origins, i, tomb if m else None)
            t0 = time.perf_counter()
            got = cpu.run_many([spec for _, spec, _ in reqs],
                               [pol for _, _, pol in reqs])
            rec = {"i": i, "version": plan.version,
                   "digest": _plan_digest(plan),
                   "names": [name for name, _, _ in reqs],
                   "results": [_slim(r) for r in got],
                   "cpu_s": time.perf_counter() - t0, "ref": None}
            if i in (0, len(events) - 1):
                t0 = time.perf_counter()
                rec["ref"], _ = run_query_reference(
                    plan.top, origins[0], p, dynamic=True,
                    lifetime_mean_s=OV_PARITY_LIFETIME_S)
                rec["ref_s"] = time.perf_counter() - t0
            out.put(rec)
    except Exception:                    # noqa: BLE001 — sent to the parent
        out.put(traceback.format_exc())


def _overlay(dev, gen, errs, _build):
    """Serve top-k requests on the card while peers join and leave: each
    event is followed by an incremental ``plan.sync()`` (timed) and a
    drained ``QueryServer`` batch over the overlay-bound engine, held
    bit for bit to a card engine on a plan rebuilt from scratch (timed,
    with its upload) and to the port's CPU path on the synced plan
    (:func:`_overlay_cpu`, a process that replays the same events on the
    same overlay while the card works; its plan's graph must be this
    one's, event by event).  Returns the launches of the served
    batches."""
    import multiprocessing
    import numpy as np
    origins = sorted(int(o) for o in np.random.default_rng(11).choice(
        OV_PEERS, OV_ORIGINS, replace=False))
    ctx = multiprocessing.get_context("spawn")
    cpu_out = ctx.Queue()
    cpu_proc = ctx.Process(target=_overlay_cpu,
                           args=(cpu_out, OV_PEERS, origins), daemon=True)
    cpu_proc.start()
    try:
        return _overlay_on_card(dev, gen, errs, _build, origins, cpu_out,
                                cpu_proc)
    finally:
        cpu_proc.join(timeout=60)
        if cpu_proc.is_alive():
            cpu_proc.kill()
            cpu_proc.join()


def _cpu_record(cpu_out, cpu_proc, i):
    """Event ``i``'s record from :func:`_overlay_cpu`."""
    import queue
    while True:
        try:
            rec = cpu_out.get(timeout=10)
            break
        except queue.Empty:
            _require(cpu_proc.is_alive(), "phase 9's CPU path process "
                     f"exited {cpu_proc.exitcode} before event {i}")
    _require(not isinstance(rec, str), f"phase 9's CPU path failed:\n{rec}")
    _require(rec["i"] == i, f"phase 9's CPU path sent event {rec['i']}, "
             f"want {i}")
    return rec


def _overlay_on_card(dev, gen, errs, _build, origins, cpu_out, cpu_proc):
    """:func:`_overlay`'s work on the card."""
    import torch
    from repro_torch.engine import (NetworkPlan, Overlay, QueryServer,
                                    ServerConfig, SimEngine)
    from repro_torch.engine.sim_torch import _device_slices
    from repro_torch.p2psim import SimParams, build_topology
    t0 = time.perf_counter()
    ov = Overlay(build_topology("hierarchical", OV_PEERS, seed=7))
    p = SimParams(seed=0)
    engine = SimEngine(ov, p, device=dev)
    plan = engine.plan
    host_s, up_s = _warm_hot_set(engine, origins)
    print(f"[overlay] hierarchical n={ov.n} edges={ov.top.n_edges}, "
          f"{OV_ORIGINS} origins {origins}: built in "
          f"{time.perf_counter() - t0:.3f} s (hot set {host_s:.3f} s "
          f"host, {up_s:.3f} s upload)")
    events = _overlay_events()
    counts = dict.fromkeys(_build.LAUNCHES, 0)
    tomb = None
    for i, (event, m) in enumerate(events):
        tomb = _overlay_event(ov, plan, origins, i, event, m, tomb)
        t0 = time.perf_counter()
        moved = plan.sync()
        sync_s = time.perf_counter() - t0
        _require(moved, f"{event}: plan.sync() found nothing to do")
        reqs = _overlay_requests(origins, i, tomb if m else None)
        server = QueryServer(engine, ServerConfig(max_queue=256,
                                                  max_batch=64))
        _build.reset_launches()          # count the served batch alone
        handles = [(name, server.submit(spec, pol))
                   for name, spec, pol in reqs]
        server.start()                   # one cycle takes every request
        try:
            served = [(name, h.result(timeout=900)) for name, h in handles]
        finally:
            server.stop(drain=True, timeout=60)
        for name, c in _build.LAUNCHES.items():
            counts[name] += c
        sm = server.metrics()
        _require(sm.served == sm.submitted == len(reqs) and sm.failed == 0,
                 f"{event}: served {sm.served} of {sm.submitted}, failed "
                 f"{sm.failed}")
        _require(plan.version == ov.version, f"{event}: plan at version "
                 f"{plan.version}, overlay at {ov.version}")
        # the same requests on a plan rebuilt from scratch, warmed the same
        t0 = time.perf_counter()
        fresh = SimEngine(NetworkPlan(ov.top), p, device=dev)
        reb_host, reb_up = _warm_hot_set(fresh, origins)
        rebuild_s = time.perf_counter() - t0 - reb_up
        specs = [spec for _, spec, _ in reqs]
        pols = [pol for _, _, pol in reqs]
        t0 = time.perf_counter()
        rebuilt = fresh.run_many(specs, pols)
        fresh_s = time.perf_counter() - t0
        # the CPU path's run of the same requests on its replayed plan
        t0 = time.perf_counter()
        rec = _cpu_record(cpu_out, cpu_proc, i)
        cpu_wait_s = time.perf_counter() - t0
        _require(rec["version"] == plan.version
                 and rec["digest"] == _plan_digest(plan)
                 and rec["names"] == [name for name, _ in served],
                 f"{event}: the CPU path's plan or requests differ from "
                 f"the card's (version {rec['version']} vs {plan.version})")
        for (name, res), rf, rc in zip(served, rebuilt, rec["results"]):
            _require(res.backend_used == "sim-torch" and res.precision
                     == "f64", f"{event} {name}: {res.backend_used} "
                     f"{res.precision}")
            _require_same_result(f"{event} {name}", res, rf,
                                 "a plan rebuilt from scratch")
            _require_same_result(f"{event} {name}", res, rc)
        if tomb is not None and m:
            res = served[-1][1]
            _require(int(res.metrics.n_reached[0, 0]) == 1,
                     f"{event}: the departed peer {tomb} reached "
                     f"{res.metrics.n_reached[0, 0]} peers")
        ref_s = (_check_reference(engine, origins[0], rec["ref"])
                 if i in (0, len(events) - 1) else None)
        lat = sm.latency
        line = {
            "event": event, "n_peers": ov.n, "version": ov.version,
            "requests": len(reqs), "departed_origin": tomb if m else None,
            "sync_s": sync_s, "compile_s_first": served[0][1].compile_s,
            "compile_s_all": sum(r.compile_s / r.batch_size
                                 for _, r in served),
            "rebuild_s": rebuild_s, "rebuild_upload_s": reb_up,
            "rebuild_hot_set_host_s": reb_host,
            "served_p50_s": lat.p50_s, "served_p95_s": lat.p95_s,
            "served_p99_s": lat.p99_s, "run_s_max": sm.run_s.max,
            "rebuilt_run_many_s": fresh_s,
            "cpu_run_many_s": rec["cpu_s"], "cpu_wait_s": cpu_wait_s,
            "reference_s": rec.get("ref_s"), "reference_check_s": ref_s,
            "parity": True}
        print("[overlay] " + json.dumps(line))
    print("[overlay] launches " + json.dumps(counts))
    for name in ("merge", "arrivals", "wait", "wait_churn"):
        _require(counts[name] > 0, f"kernel {name} never launched on the "
                 "live-overlay path")
    # the kernels at the synced plan's own shapes (origin 0 of the hot set)
    st = plan.origin_statics([origins[0]], 0, "st1+2")[0][0]
    levels = _device_slices(plan.depth_slices(st), dev)[0]
    n = _check_levels("overlay", levels, OV_ORIGINS, torch.float64, gen,
                      dev, errs)
    n += _check_merges_at(_merge_calls(_merge_pairs(levels), dev, gen),
                          errs, "the synced overlay")
    print(f"[overlay] {n} kernel checks at the synced plan's shapes "
          "bit-equal to the plain versions")
    return counts


# ---------------------------------------------------------------------------
# phase 10: the serving CLI and entry sharding
# ---------------------------------------------------------------------------

# the CLI as a user starts it: two warm 100k-peer engines (BA, the
# reference's jax_backend overlay, and hierarchical, the live-overlay
# one), 16 requests (cut from 32 to fit the call's time) from 8
# closed-loop clients, fd-dynamic and cn round-robin, on the card
CLI_REQUESTS = 16
CLI_ARGV = ["overlay", "--topology", "ba,hierarchical", "--n-peers",
            str(N_PEERS), "--requests", str(CLI_REQUESTS), "--concurrency",
            "8", "--policies", "fd-dynamic,cn", "--device", "cuda"]
# the sharded sweep's entries (cut from E_MAIN's 32 to fit the call's
# time) and its forced chunks on one card: each chunk is one sweep of
# SHARD_E / SHARD_CHUNKS entries under torch.cuda.device(0)
SHARD_E = 8
SHARD_CHUNKS = 4


def _cli(card, _build):
    """``repro_torch.launch.serve.main(CLI_ARGV)`` in process: every
    request served, nothing shed, timed out or failed, and the merge,
    arrivals and wait kernels launched."""
    from repro_torch.launch import serve
    _build.reset_launches()              # count the CLI's run alone
    t0 = time.perf_counter()
    m = serve.main(CLI_ARGV)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    print("[cli] serving metrics " + json.dumps(m))
    print("[cli] launches " + json.dumps(launches))
    _require(m["served"] == CLI_REQUESTS and m["shed"] == 0
             and m["timed_out"] == 0 and m["failed"] == 0,
             f"CLI served {m['served']} of {CLI_REQUESTS}, shed "
             f"{m['shed']}, timed out {m['timed_out']}, failed "
             f"{m['failed']}")
    for name in ("merge", "arrivals", "wait"):
        _require(launches[name] > 0, f"kernel {name} never launched on "
                 "the CLI's path")
    lat = m["latency"]
    print(f"[cli] {CLI_REQUESTS} requests: throughput "
          f"{m['throughput_qps']} qps, latency p50 {lat['p50_s']} s, p95 "
          f"{lat['p95_s']} s, p99 {lat['p99_s']} s (main() {wall:.3f} s "
          f"with its build and warm-up); {card}")
    return launches


def _shard(engine, p, dev, gen, errs, _build):
    """``SimEngine(shard=True)`` on the phase-3 overlay: 8 independent
    fd-dynamic entries, f64 and validated f32, equal to ``shard=False``
    bit for bit; with one card ``shard=True`` is the unsharded sweep,
    so the same runs are repeated on ``SHARD_CHUNKS`` forced chunks of
    the card (f32 unvalidated); the kernels held to their plain versions
    at a chunk's shapes."""
    import torch
    from repro_torch.engine import QuerySpec, SimEngine
    from repro_torch.engine.sim_torch import _device_slices
    n_dev = torch.cuda.device_count()
    one = torch.device("cuda", 0)
    engines = {
        "shard=False": SimEngine(engine.plan, p),
        "shard=True": SimEngine(engine.plan, p, shard=True),
        # f32 unvalidated here: its f64 rerun would repeat the f64 run
        f"{SHARD_CHUNKS} forced chunks": SimEngine(
            engine.plan, p, shard=True, validate_precision=False,
            _shard_devices=[one] * SHARD_CHUNKS),
    }
    _require(engines["shard=True"]._shard is None or n_dev > 1,
             "shard=True split the entries over one card")
    spec = QuerySpec(origins=(0,), n_trials=SHARD_E, seed=4242,
                     rng="independent")
    base, counts = {}, {}
    for name, eng in engines.items():
        if name != "shard=False":
            _build.reset_launches()
        for prec in ("f64", "f32"):
            t0 = time.perf_counter()
            res = eng.run(dataclasses.replace(spec, precision=prec))
            wall = time.perf_counter() - t0
            what = f"{name} {prec}"
            if name == "shard=False":
                base[prec] = res
            else:
                _require_same_result(what, res, base[prec],
                                     other="shard=False")
            if prec == "f32" and eng._validate_precision:
                tol = res.extras["tolerance"]
                _require(tol["ok"] and tol == base[prec].extras["tolerance"],
                         f"{what}: tolerance {tol}")
            print(f"[shard] {what}: {SHARD_E} entries in {wall:.3f} s host "
                  f"wall (compile_s {res.compile_s:.3f})"
                  + ("" if name == "shard=False" else
                     "; values, indices, metrics == shard=False bit for bit"))
        if name != "shard=False":
            counts[name] = dict(_build.LAUNCHES)
            for k in ("merge", "arrivals", "wait"):
                _require(counts[name][k] > 0, f"kernel {k} never launched "
                         f"on the {name} path")
    print("[shard] launches " + json.dumps(counts))
    st = engine.plan.origin_statics([0], p.ttl, "st1+2")[0][0]
    levels = _device_slices(engine.plan.depth_slices(st), dev)[0]
    rows = SHARD_E // SHARD_CHUNKS
    n = 0
    for dt in (torch.float64, torch.float32):
        n += _check_levels("a chunk", levels, rows, dt, gen, dev, errs)
    n += _check_merges_at(_merge_calls(_merge_pairs(levels), dev, gen,
                                       rows=rows), errs, "a chunk")
    print(f"[shard] {n} kernel checks at a chunk's shapes (E={rows}) "
          "bit-equal to the plain versions")
    total = {k: sum(c[k] for c in counts.values())
             for k in next(iter(counts.values()))}
    return total


# ---------------------------------------------------------------------------
# phase 11: the LM decode path on the card
# ---------------------------------------------------------------------------

# the reference's documented decode command (launch/serve.py's
# docstring) without --smoke: qwen2-0.5b's full width and depth, random
# weights from seed 0, the vocabulary sharded over 16 peers: the
# production mesh's model axis (launch/mesh.py:23)
DEC_ARCH, DEC_B, DEC_PROMPT, DEC_GEN, DEC_P, DEC_K = (
    "qwen2-0.5b", 4, 32, 16, 16, 20)
# the model against the CPU path: full width, 2 layers, f32, TF32 off,
# 4 teacher-forced steps; the tolerance of tests/test_torch_models.py
DEC_XCHECK_LAYERS, DEC_FORCED = 2, 4
DEC_TOL = {"rtol": 1e-4, "atol": 1e-5}
# decode steps in the profiled window
DEC_PROFILE_STEPS = 5


def _decode_argv(arch):
    return ["decode", "--arch", arch, "--batch", str(DEC_B),
            "--prompt-len", str(DEC_PROMPT), "--gen", str(DEC_GEN),
            "--model-par", str(DEC_P), "--device", "cuda"]


def _check_decode_run(what, cfg, toks, launches):
    """Tokens (4, 16) inside the padded vocabulary, and the top-k and
    the merge launched on every step (FD halving over 16 peers: one
    top-k and log2(16) merges a step)."""
    steps = DEC_GEN - 1
    v_pad = cfg.padded_vocab()
    _require(tuple(toks.shape) == (DEC_B, DEC_GEN) and int(toks.min()) >= 0
             and int(toks.max()) < v_pad,
             f"{what}: tokens {tuple(toks.shape)} in [{toks.min()}, "
             f"{toks.max()}], want ({DEC_B}, {DEC_GEN}) in [0, {v_pad})")
    rounds = int(math.log2(DEC_P))
    _require(launches["topk"] >= steps and launches["merge"]
             >= steps * rounds, f"{what}: {launches['topk']} top-k and "
             f"{launches['merge']} merge launches in {steps} steps")
    return {"tokens_shape": list(toks.shape),
            "topk_per_step": launches["topk"] / steps,
            "merge_per_step": launches["merge"] / steps,
            "ids_past_vocab": int((toks >= cfg.vocab_size).sum())}


def _decode_cli(card, _build, arch=DEC_ARCH, what="decode"):
    """``repro_torch.launch.serve.main`` with ``_decode_argv(arch)`` in
    process, checked by :func:`_check_decode_run`.  Returns (launches,
    the CLI's own numbers, parsed from its two-decimal print)."""
    import contextlib
    import io
    import re
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    buf = io.StringIO()
    _build.reset_launches()              # count the CLI's run alone
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        toks = serve.main(_decode_argv(arch))
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    print(buf.getvalue(), end="")
    print(f"[{what}] CLI launches " + json.dumps(launches))
    checked = _check_decode_run(f"{what} CLI", get_config(arch), toks,
                                launches)
    m = re.search(r"prefill \d+ tok in ([\d.]+)s; decoded \d+ steps in "
                  r"([\d.]+)s \(([\d.]+) tok/s\)", buf.getvalue())
    _require(m is not None, f"{what} CLI: no timing line")
    res = {"prefill_s": float(m[1]), "decode_s": float(m[2]),
           "tok_per_s": float(m[3]), "main_s": wall, **checked}
    print(f"[{what}] CLI " + json.dumps(res) + f"; {card}")
    return launches, res


def _decode_batch(cfg, rng, batch, dev, prompt=DEC_PROMPT):
    """A prompt of ``prompt`` tokens from ``rng`` and the modality
    stubs' inputs (``extra_model_inputs``: f32 frames, f32 vision
    embeddings), on ``dev``."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import extra_model_inputs
    tokens = rng.integers(0, cfg.vocab_size,
                          (batch, prompt)).astype(np.int32)
    return {k: torch.from_numpy(v).to(dev)
            for k, v in extra_model_inputs(cfg, {"tokens": tokens}).items()}


def _decode_model(dev, card, cfg=None, what="decode",
                  profile_steps=DEC_PROFILE_STEPS, prompt=DEC_PROMPT,
                  after=None):
    """The CLI's model (``cfg``, qwen2-0.5b by default) and prompt
    (``prompt`` tokens) built again: prefill and each decode step timed
    with the device synchronised, the CLI's unsynchronised loop, and one
    profiler window of ``profile_steps`` steps split into the model's
    and the sampling's device time, with the device's idle share; then
    ``after(params, batch, state, tok)``, its result under
    ``res["after"]``.  Returns (one step's f32 scores (4, V_pad),
    numbers)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import state_from_prefill
    from repro_torch.models import model as M
    from repro_torch.runtime.steps import (gumbel, make_serve_step,
                                           sample_topk)
    cfg = cfg or get_config(DEC_ARCH)
    s_max = prompt + DEC_GEN
    t0 = time.perf_counter()
    params = M.init_params(torch.Generator(dev).manual_seed(0), cfg,
                           max_seq=s_max, device=dev)
    torch.cuda.synchronize()
    res = {"init_s": time.perf_counter() - t0,
           "params": M.count_params(params),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in params.parameters())}
    batch = _decode_batch(cfg, np.random.default_rng(0), DEC_B, dev, prompt)
    mesh = make_host_mesh(DEC_P, device=dev, cfg=cfg)
    step = make_serve_step(cfg, mesh, k=DEC_K)

    def prefilled():
        last, pst = M.prefill(params, cfg, batch)
        st = state_from_prefill(cfg, pst, s_max)
        return st, torch.argmax(last, dim=-1)[:, None].to(torch.int32)

    prefill_s = []
    for _ in range(3):                   # the first is cold
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, tok = prefilled()
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    gen = torch.Generator(dev).manual_seed(1)
    step_s = []
    for _ in range(DEC_GEN - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, state = step(params, state, tok, gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    # the CLI's loop: no synchronise between steps, tokens read at the end
    state, tok = prefilled()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = []
    for _ in range(DEC_GEN - 1):
        tok, state = step(params, state, tok, gen)
        toks.append(tok)
    torch.cat(toks, dim=1).cpu()
    loop_s = time.perf_counter() - t0
    res.update({
        "prefill_s": prefill_s, "step_s": step_s,
        "step_ms_mean_warm": statistics.fmean(step_s[1:]) * 1e3,
        "loop_s": loop_s,
        "tok_per_s": (DEC_GEN - 1) * DEC_B / loop_s})

    # one window of steps at the last position, split by tag
    box = {}

    def model_part():
        box["logits"], _ = M.decode_step(params, cfg, state, tok)

    def sampling_part():
        vals, idx = step.select(box["logits"][:, 0].float())
        box["tok"] = sample_topk(vals, idx, gumbel(vals.shape, gen))

    calls = [tagged("model", model_part), tagged("sampling", sampling_part)]
    for fn in calls:
        fn()

    def window():
        t0 = time.perf_counter()
        for _ in range(profile_steps):
            for fn in calls:
                fn()
        torch.cuda.synchronize()
        box["wall"] = time.perf_counter() - t0

    kernels, tags = _trace_kernels(_profiled(window))
    wall = box["wall"]
    n = profile_steps
    by_tag = {}
    for tag, name, _, dur in kernels:
        by_tag.setdefault(tag, {}).setdefault(name, []).append(dur)
    _require(set(by_tag) >= {"model", "sampling"},
             f"{what} profile: kernels by tag {sorted(map(str, by_tag))}")
    ivs = sorted((ts, ts + dur) for tag, _, ts, dur in kernels
                 if tag is not None)
    busy, end = 0.0, -math.inf
    for a, b in ivs:                     # the union of kernel intervals
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    span = end - tags[0][0]
    split = {tag: {"device_ms": sum(map(sum, ks.values())) / n / 1e3,
                   "kernels_per_step": sum(map(len, ks.values())) / n,
                   "top": sorted(((k, sum(v) / n / 1e3)
                                  for k, v in ks.items()),
                                 key=lambda kv: -kv[1])[:6]}
             for tag, ks in by_tag.items() if tag is not None}
    res["profile"] = {
        "steps": n, "wall_ms_per_step": wall / n * 1e3,
        "span_ms_per_step": span / n / 1e3,
        "busy_ms_per_step": busy / n / 1e3,
        "idle_share": 1 - busy / span,
        # the same busy time against a step timed without the profiler
        "idle_share_of_synced_step": 1 - busy / n / 1e3
        / res["step_ms_mean_warm"], "by_tag": split}
    print(f"[{what}] model {cfg.name}, {cfg.n_layers} layers "
          + json.dumps(res) + f"; {card}")
    if after is not None:
        res["after"] = after(params, batch, state, tok)
    return box["logits"][:, 0].float(), res


def _decode_topk_ok(what, v, i, scores, k):
    """A k-list of each row: descending, its indices distinct and
    pointing at their scores."""
    import torch
    _require(v.shape == (scores.shape[0], k) and i.dtype == torch.int32
             and bool((v[:, :-1] >= v[:, 1:]).all())
             and _same(torch.gather(scores, 1, i.long()), v)
             and all(len(set(r.tolist())) == k for r in i),
             f"{what}: not a top-{k} of its scores")


def _decode_sampling(scores):
    """On one step's f32 scores: the serve step's top-k on the card ==
    the port's CPU path, bit for bit, at 16 peers (FD halving, doubling,
    ring; CN; CN*) and at one peer; values == ``topk_ref`` of the whole
    row, and indices too except under ring (peer 0 merges its partners
    from the top down, so tied winners may come in another order, or
    another of the tied scores at the k-th may win); the sampled token
    equal given one noise tensor."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.topk import topk_ref
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.steps import gumbel, make_serve_step, \
        sample_topk
    cfg = get_config(DEC_ARCH)
    host = scores.cpu()
    rv, ri = topk_ref(host, DEC_K)
    noise = gumbel(rv.shape, torch.Generator(scores.device).manual_seed(2))
    # ties among a row's top k + 1 scores (bf16 logits cast to f32 tie)
    top = topk_ref(host, DEC_K + 1)[0]
    ties = int((top[:, 1:] == top[:, :-1]).sum())
    cases = [(DEC_P, "fd", sch) for sch in SCHEDULES] + [
        (DEC_P, "cn", "halving"), (DEC_P, "cn_star", "halving"),
        (1, "fd", "halving")]
    for p, alg, sch in cases:
        what = f"decode sampling P={p} {alg}/{sch}"
        kw = dict(k=DEC_K, algorithm=alg, schedule=sch)
        card = make_serve_step(cfg, make_host_mesh(
            p, device=scores.device, cfg=cfg), **kw).select(scores)
        cpu = make_serve_step(cfg, make_host_mesh(
            p, device="cpu", cfg=cfg), **kw).select(host)
        _require(_same(card[0].cpu(), cpu[0]) and _same(card[1].cpu(),
                                                        cpu[1]),
                 f"{what}: card != CPU path")
        _decode_topk_ok(what, cpu[0], cpu[1], host, DEC_K)
        _require(_same(cpu[0], rv) and (sch == "ring" or _same(cpu[1], ri)),
                 f"{what}: != topk_ref of the whole row")
        t_card = sample_topk(*card, noise)
        _require(_same(t_card.cpu(), sample_topk(*cpu, noise.cpu())),
                 f"{what}: sampled token card != CPU path")
    print(f"[decode] sampling on one step's scores {tuple(scores.shape)}: "
          f"{len(cases)} top-k cases card == CPU path bit for bit, values "
          f"== topk_ref (indices too but under ring), sampled tokens equal "
          f"given one noise tensor; {ties} tied neighbours among the rows' "
          f"top {DEC_K + 1}")


def _decode_xcheck(dev, errs, cfg=None, batch=DEC_B, key="decode_model",
                   what="decode", exact=False):
    """``cfg`` (qwen2-0.5b at ``DEC_XCHECK_LAYERS`` layers by default;
    full width) in f32, TF32 off: prefill's last logits,
    ``state_from_prefill``'s caches and ``DEC_FORCED`` teacher-forced
    steps (logits and every cache tensor) on the card against the
    port's CPU path on the same weights (drawn on the card, copied to
    the host), within ``DEC_TOL``.  With ``exact`` the CPU path runs
    the model cast to f64 (its products, norms and recurrences in f64;
    ``flash_attention``'s, the decode attention's and the top-k's values
    stay f32), so the card's f32 is held to the exact function rather
    than to the CPU's own f32 rounding."""
    import copy
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import state_from_prefill
    from repro_torch.models import model as M
    cfg = dataclasses.replace(
        cfg or dataclasses.replace(get_config(DEC_ARCH),
                                   n_layers=DEC_XCHECK_LAYERS),
        param_dtype="float32", compute_dtype="float32")
    s_max = DEC_PROMPT + DEC_FORCED
    t0 = time.perf_counter()
    card = M.init_params(torch.Generator(dev).manual_seed(0), cfg,
                         max_seq=s_max, device=dev)
    host = copy.deepcopy(card).to("cpu")
    host_dt = torch.float64 if exact else torch.float32
    host = host.to(host_dt)
    rng = np.random.default_rng(3)
    inputs = _decode_batch(cfg, rng, batch, "cpu")
    forced = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, DEC_FORCED)).astype(np.int32))

    def cache_tensors(prefix, st):
        # a recurrent state is one tensor, an attention cache a tuple
        return {f"{prefix} {c} {name} {j}": a.clone()
                for c, layer in enumerate(st.caches)
                for name, cache in layer.items()
                for j, a in enumerate([cache] if torch.is_tensor(cache)
                                      else cache)}

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        outs, routed = [], []
        for params, d, dt in ((card, dev, torch.float32),
                              (host, "cpu", host_dt)):
            with _router_probs() as seen:
                last, st = M.prefill(params, cfg, {
                    k: v.to(d, dt) if v.is_floating_point() else v.to(d)
                    for k, v in inputs.items()})
                st = state_from_prefill(cfg, st, s_max, cache_dtype=dt)
                got = {"prefill": last, **cache_tensors("padded cache", st)}
                for i in range(DEC_FORCED):
                    lg, st = M.decode_step(params, cfg, st,
                                           forced[:, i:i + 1].to(d))
                    got[f"step {i}"] = lg[:, 0]
                got.update(cache_tensors("cache", st))
            outs.append({k: v.cpu() for k, v in got.items()})
            routed.append(seen)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    # the routers' smallest gap between a token's k-th and (k+1)-th
    # expert probability: a tie within rounding could pick another expert
    margin = _router_margin(routed[1]) if routed[1] else None
    worst = {}
    for name, want in outs[1].items():
        got = outs[0][name].to(want.dtype)
        worst[name] = _max_abs_err(got, want)
        try:
            torch.testing.assert_close(got, want, **DEC_TOL)
        except AssertionError as e:
            raise PhaseError(f"{what} cross-check {name}: card != CPU path "
                             f"within {DEC_TOL} (router margin {margin}): "
                             f"{e}") from None
    errs[key] = max(worst.values())
    top = dict(sorted(worst.items(), key=lambda kv: -kv[1])[:8])
    print(f"[{what}] {cfg.name} at full width, {cfg.n_layers} layers"
          + (f" + {cfg.n_encoder_layers} encoder layers over "
             f"{cfg.encoder_seq} frames" if cfg.is_encoder_decoder else "")
          + (f", window {cfg.local_window}" if cfg.local_window else "")
          + f", batch {batch}, f32, TF32 off: prefill logits, padded "
          f"caches and {DEC_FORCED} teacher-forced steps ({len(worst)} "
          f"tensors), card == CPU path"
          + (" in f64" if exact else "") + f" within {DEC_TOL}; max abs err "
          f"{errs[key]}"
          + ("" if margin is None else f", router margin {margin}")
          + ", largest " + json.dumps(top)
          + f" ({time.perf_counter() - t0:.3f} s)")


def _decode_kernels(scores, errs, what="decode"):
    """The kernels at a decode's shapes, bit-equal to their plain
    versions: the top-k over the 16 peers' shards (64, V_pad / 16; for
    qwen2-0.5b (64, 9,600)), as the (4, 16, V_pad / 16) view the FD step
    hands it, and over the whole row (4, V_pad); the merge on each
    halving round's (4, 16, 20) lists, the non-receivers masked to
    -inf / -1, into outputs filled with NaN."""
    import torch
    from repro_torch.core import fd
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.kernels.merge import merge_ref
    from repro_torch.kernels.merge.merge import merge_cuda
    from repro_torch.kernels.topk import topk_cuda, topk_ref
    b = scores.shape[0]
    local = scores.view(b, DEC_P, -1)
    n, shapes = 0, []
    for part, x in (("the peers' shards", local.reshape(b * DEC_P, -1)),
                    ("the (B, P, n) view", local), ("the whole row", scores)):
        v1, i1 = topk_cuda(x, DEC_K)
        v2, i2 = topk_ref(x, DEC_K)
        errs["topk"] = max(errs["topk"], _max_abs_err(v1, v2))
        _require(_same(v1, v2) and _same(i1, i2),
                 f"{what}: topk at {part} {tuple(x.shape)}: kernel != "
                 "plain version")
        shapes.append(tuple(x.shape))
        n += 1
    vals, idx = fd._local_lists(local, DEC_K)
    masked = 0
    for perm, recv in fd.schedule_rounds("halving", DEC_P, scores.device):
        pv = torch.where(recv[:, None], mesh_mod.ppermute(vals, perm),
                         float("-inf"))
        pi = torch.where(recv[:, None], mesh_mod.ppermute(idx, perm), -1)
        masked += int((~recv).sum()) * b
        got = merge_cuda(vals, idx, pv, pi,
                         out=_nan_out(vals.shape, vals.dtype, vals.device))
        want = merge_ref(vals, idx, pv, pi)
        errs["merge"] = max(errs["merge"], _max_abs_err(got[0], want[0]))
        _require(_same(got[0], want[0]) and _same(got[1], want[1]),
                 f"{what}: merge at {tuple(vals.shape)} lists: kernel "
                 "!= plain version")
        vals, idx = want
        n += 1
    print(f"[{what}] {n} kernel checks bit-equal to the plain versions: "
          f"top-k at {shapes}, merge at {tuple(vals.shape)} ({masked} "
          "masked lists)")


# ---------------------------------------------------------------------------
# phase 12: the attention variants on the card
# ---------------------------------------------------------------------------

# the same decode command for each variant: MLA and the encoder-decoder
# at full size through the CLI; qwen2-vl-72b (145.46 GB in bf16) at its
# full width with its depth cut to fit one card, through the functions
# the CLI calls
VAR_CLI = ("minicpm3-4b", "whisper-large-v3")
VAR_VL, VAR_VL_LAYERS = "qwen2-vl-72b", 4
# the f32 cross-checks at full width: (layers, encoder layers, batch);
# qwen2-vl at batch 4, not 1: at batch 1 the CPU path's own 8,192-wide
# f32 products (one row: a less exact matrix-vector route) miss rtol
# 1e-4 / atol 1e-5 against an f64 run (tools/decode_xcheck_error.py)
VAR_XCHECK = {"minicpm3-4b": (2, 0, DEC_B), "whisper-large-v3": (2, 2, DEC_B),
              VAR_VL: (1, 0, DEC_B)}
# decode steps in each variant's profiled window
VAR_PROFILE_STEPS = 2
# the depth (decoder and encoder layers) of phases 12 and 13's timed and
# profiled model (:func:`_decode_model`), cut to fit the call's time;
# their CLI runs keep the arch's own depth
MODEL_LAYERS = 8


def _model_depth(cfg):
    """``cfg`` with at most ``MODEL_LAYERS`` decoder and encoder layers."""
    return dataclasses.replace(
        cfg, n_layers=min(cfg.n_layers, MODEL_LAYERS),
        n_encoder_layers=min(cfg.n_encoder_layers, MODEL_LAYERS))


def _free_card():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _decode_functions(dev, card, _build, cfg, what, prompt=DEC_PROMPT,
                      on_state=None):
    """The decode CLI's steps through the functions it calls
    (``init_params``, ``prefill``, ``state_from_prefill``,
    ``make_serve_step``) for a ``cfg`` or a ``prompt`` length the CLI
    cannot name (a cut depth, a prompt past a window), checked by
    :func:`_check_decode_run`; ``on_state`` sees the last decode state.
    Returns (launches, numbers)."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import state_from_prefill
    from repro_torch.models import model as M
    from repro_torch.runtime.steps import make_serve_step
    s_max = prompt + DEC_GEN
    _build.reset_launches()              # count this run alone
    t0 = time.perf_counter()
    mesh = make_host_mesh(DEC_P, device=dev, cfg=cfg)
    params = M.init_params(torch.Generator(dev).manual_seed(0), cfg,
                           max_seq=s_max, device=dev)
    batch = _decode_batch(cfg, np.random.default_rng(0), DEC_B, dev, prompt)
    step = make_serve_step(cfg, mesh, k=DEC_K)
    t1 = time.perf_counter()
    last, pst = M.prefill(params, cfg, batch)
    state = state_from_prefill(cfg, pst, s_max)
    tok = torch.argmax(last, dim=-1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t1
    gen = torch.Generator(dev).manual_seed(1)
    out = [tok]
    t1 = time.perf_counter()
    for _ in range(DEC_GEN - 1):
        tok, state = step(params, state, tok, gen)
        out.append(tok)
    toks = torch.cat(out, dim=1).cpu().numpy()
    t_decode = time.perf_counter() - t1
    launches = dict(_build.LAUNCHES)
    print(f"[{what}] launches " + json.dumps(launches))
    if on_state is not None:
        on_state(state)
    res = {"prefill_s": t_prefill, "decode_s": t_decode,
           "tok_per_s": (DEC_GEN - 1) * DEC_B / t_decode,
           "main_s": time.perf_counter() - t0,
           **_check_decode_run(what, cfg, toks, launches)}
    print(f"[{what}] {cfg.name} at {cfg.n_layers} layers "
          + json.dumps(res) + f"; {card}")
    return launches, res


def _variants(dev, card, errs, _build):
    """Phase 12: minicpm3-4b (MLA) and whisper-large-v3 (encoder,
    cross attention, learned positions) through the decode CLI at full
    size, qwen2-vl-72b (M-RoPE, the vision stub) at full width and
    ``VAR_VL_LAYERS`` layers through the CLI's functions; each timed and
    profiled at ``MODEL_LAYERS`` layers (:func:`_decode_model`), held in
    f32 to the CPU path
    (:func:`_decode_xcheck`) and its kernels to their plain versions at
    its shapes (:func:`_decode_kernels`).  Returns (launches by path,
    one step's f32 scores by arch)."""
    from repro_torch.configs.base import get_config
    launches, scores = {}, {}
    for arch in VAR_CLI + (VAR_VL,):
        t0 = time.perf_counter()
        what = f"variants {arch}"
        cfg = get_config(arch)
        if arch == VAR_VL:
            cfg = dataclasses.replace(cfg, n_layers=VAR_VL_LAYERS)
            launches[f"variants_{arch}"], _ = _decode_functions(
                dev, card, _build, cfg, what)
        else:
            launches[f"variants_{arch}"], _ = _decode_cli(card, _build, arch,
                                                          what)
        _free_card()
        scores[arch], _ = _decode_model(dev, card, _model_depth(cfg), what,
                                        VAR_PROFILE_STEPS)
        _free_card()
        layers, enc_layers, batch = VAR_XCHECK[arch]
        _decode_xcheck(dev, errs, dataclasses.replace(
            cfg, n_layers=layers, n_encoder_layers=enc_layers),
            batch, f"variants_{arch}", what)
        _free_card()
        _decode_kernels(scores[arch], errs, what)
        print(f"[{what}] {time.perf_counter() - t0:.3f} s")
    return launches, scores


# ---------------------------------------------------------------------------
# phase 13: MoE, RWKV-6 and Griffin with the window cache on the card
# ---------------------------------------------------------------------------

# the same decode command for the last four archs at full size (random
# bf16 weights from seed 0, f32 caches, batch 4, 16 tokens, FD halving
# over 16 peers, k = 20): granite-moe through the CLI, the rest through
# the functions the CLI calls; recurrentgemma's prompt is 2,080 tokens,
# so its 2,048-slot ring wraps while it decodes (s_max 2,096)
ARCH_CLI = "granite-moe-1b-a400m"
ARCHS = (ARCH_CLI, "moonshot-v1-16b-a3b", "rwkv6-3b", "recurrentgemma-2b")
ARCH_PROMPT = {"recurrentgemma-2b": 2_080}
# depths cut to fit the call's time (moonshot's 48 layers: 57.8 GB of
# bf16 weights to make and a router a layer a step)
ARCH_LAYERS = {"moonshot-v1-16b-a3b": 24}
# the f32 cross-checks at full width, the card's f32 against the CPU
# path in f64 (the exact function): at these widths the CPU's own f32
# rounding is as large as the card's, and recurrentgemma's card-vs-CPU
# f32 logits missed the tolerance on 5 of 1,024,000 though each was
# within it of f64 (tools/decode_xcheck_error.py --caches); layers:
# recurrentgemma's 3 are one whole rglru, rglru, attn group; rwkv6-3b
# at 1, since at 2 neither f32 path is within the tolerance of f64 on
# layer 1's state (|state| up to 40; 53 and 54 of 655,360 outside);
# recurrentgemma's window cut to 16 slots, so that the 32-token prompt
# wraps the ring on the host without a 2,080-token prefill there
ARCH_XCHECK = {ARCH_CLI: 2, "moonshot-v1-16b-a3b": 2, "rwkv6-3b": 1,
               "recurrentgemma-2b": 3}
ARCH_XCHECK_WINDOW = 16


class _router_probs:
    """A context in which every MoE layer's router probabilities (T, E)
    and k, handed to the top-k, are kept (cloned) in call order."""

    def __enter__(self):
        from repro_torch.models import moe
        self.real, self.seen = moe.topk_with_grad, []

        def spy(probs, k, **kw):
            self.seen.append((probs.detach().clone(), k))
            return self.real(probs, k, **kw)
        moe.topk_with_grad = spy
        return self.seen

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.topk_with_grad = self.real


def _router_margin(seen):
    """The smallest gap, over every token of every captured router call,
    between its k-th and (k+1)-th largest expert probability."""
    from repro_torch.kernels.topk import topk_ref
    gaps = []
    for probs, k in seen:
        v, _ = topk_ref(probs.cpu(), k + 1)
        gaps.append(float((v[:, k - 1] - v[:, k]).min()))
    return min(gaps)


def _router_check(what, cfg, errs):
    """``after`` hook of :func:`_decode_model` for an MoE arch: one
    prefill and one decode step with the routers' probabilities kept;
    the top-k kernel on each (T, E) matrix bit-equal to ``topk_ref`` on
    the host.  Returns layer 0's decode and prefill probabilities."""
    from repro_torch.kernels.topk import topk_cuda, topk_ref
    from repro_torch.models import model as M

    def after(params, batch, state, tok):
        with _router_probs() as seen:
            M.prefill(params, cfg, batch)
            n_pre = len(seen)
            M.decode_step(params, cfg, state, tok)
        n = cfg.n_layers
        _require(n_pre == n and len(seen) == 2 * n,
                 f"{what}: {n_pre} prefill and {len(seen) - n_pre} decode "
                 f"router calls, want {n} each")
        for probs, k in seen:
            v1, i1 = topk_cuda(probs, k)
            v2, i2 = topk_ref(probs.cpu(), k)
            errs["topk"] = max(errs["topk"], _max_abs_err(v1.cpu(), v2))
            _require(_same(v1.cpu(), v2) and _same(i1.cpu(), i2),
                     f"{what}: router top-k at {tuple(probs.shape)} k={k}: "
                     "kernel != topk_ref")
        print(f"[{what}] router top-k on the card == topk_ref, bit for "
              f"bit, on {len(seen)} captured (T, E) matrices: prefill "
              f"{tuple(seen[0][0].shape)}, decode "
              f"{tuple(seen[n_pre][0].shape)}, k = {seen[0][1]}; smallest "
              f"k-th / (k+1)-th gap {_router_margin(seen)}")
        return {"decode": seen[n_pre][0], "prefill": seen[0][0],
                "k": seen[0][1]}
    return after


def _check_arch_launches(what, cfg, launches):
    """Exactly one top-k a step for the sampling plus one a MoE layer for
    the routers (and one a MoE layer in the prefill), and log2(16) = 4
    merges a step."""
    steps = DEC_GEN - 1
    moe_layers = cfg.n_layers if cfg.moe is not None else 0
    want = {"topk": moe_layers * (steps + 1) + steps,
            "merge": steps * int(math.log2(DEC_P)), "topk_select": 0}
    got = {k: launches[k] for k in want}
    _require(got == want, f"{what}: launches {got}, want {want}")
    print(f"[{what}] launches a step: top-k {1 + moe_layers} (sampling 1, "
          f"routers {moe_layers}), merge {want['merge'] // steps}; prefill "
          f"top-k {moe_layers}")


def _check_window_wrapped(what, cfg, prompt):
    """``on_state`` hook of :func:`_decode_functions`: every attention
    layer's ring holds the last W positions, 15 of them written past
    the prompt over slots the prefill filled."""
    w, last = cfg.local_window, prompt + DEC_GEN - 2

    def check(state):
        rings = [layer["self"].pos_slots for layer in state.caches
                 if "self" in layer]
        _require(len(rings) == cfg.layer_kinds().count("attn"),
                 f"{what}: {len(rings)} window caches")
        want = sorted(range(last - w + 1, last + 1))
        for ps in rings:
            _require(ps.shape == (w,) and sorted(ps.tolist()) == want
                     and int(ps[last % w]) == last,
                     f"{what}: ring positions {ps.min()}..{ps.max()}, want "
                     f"{want[0]}..{want[-1]}")
        print(f"[{what}] {len(rings)} rings of {w} slots hold positions "
              f"{want[0]}..{last}: decode wrapped past the window "
              f"(positions {prompt}..{last} over slots {prompt % w}.."
              f"{last % w})")
    return check


def _archs(dev, card, errs, _build):
    """Phase 13: granite-moe-1b-a400m through the decode CLI,
    moonshot-v1-16b-a3b, rwkv6-3b and recurrentgemma-2b (a 2,080-token
    prompt) through the CLI's functions, at full size (moonshot at
    ``ARCH_LAYERS``' depth); each checked
    for its exact launches, timed and profiled at ``MODEL_LAYERS``
    layers (:func:`_decode_model`),
    its routers' top-k held to ``topk_ref`` (MoE), held in f32 to the
    CPU path (:func:`_decode_xcheck`) and its sampling kernels to their
    plain versions (:func:`_decode_kernels`).  Returns (launches by path,
    one step's f32 scores by arch, layer 0's router probabilities by MoE
    arch)."""
    from repro_torch.configs.base import get_config
    launches, scores, router = {}, {}, {}
    for arch in ARCHS:
        t0 = time.perf_counter()
        what = f"archs {arch}"
        cfg = get_config(arch)
        if arch in ARCH_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=ARCH_LAYERS[arch])
        prompt = ARCH_PROMPT.get(arch, DEC_PROMPT)
        if arch == ARCH_CLI:
            n, _ = _decode_cli(card, _build, arch, what)
        else:
            n, _ = _decode_functions(
                dev, card, _build, cfg, what, prompt,
                _check_window_wrapped(what, cfg, prompt)
                if cfg.local_window else None)
        launches[f"decode_{arch}"] = n
        _check_arch_launches(what, cfg, n)
        _free_card()
        mcfg = _model_depth(cfg)
        scores[arch], res = _decode_model(
            dev, card, mcfg, what, VAR_PROFILE_STEPS, prompt,
            _router_check(what, mcfg, errs) if cfg.moe else None)
        if cfg.moe:
            router[arch] = res["after"]
        del res
        _free_card()
        xcfg = dataclasses.replace(cfg, n_layers=ARCH_XCHECK[arch])
        if cfg.local_window:
            xcfg = dataclasses.replace(xcfg, local_window=ARCH_XCHECK_WINDOW)
        _decode_xcheck(dev, errs, xcfg, DEC_B, f"decode_{arch}", what,
                       exact=True)
        _free_card()
        _decode_kernels(scores[arch], errs, what)
        print(f"[{what}] {time.perf_counter() - t0:.3f} s")
    return launches, scores, router


# ---------------------------------------------------------------------------
# phase 14: the training path on the card
# ---------------------------------------------------------------------------

# the training CLI at full size (random bf16 weights from seed 0, f32
# AdamW moments, SyntheticLM data): granite-moe-1b-a400m, 20 steps at
# batch 8, seq 128; qwen2-0.5b through build() and make_train_step with
# 2 microbatches and remat "dots".  granite's state is 13.9 GB a
# checkpoint, so the full-size call writes only its final checkpoint
# (the CLI's default --ckpt-every 50 > 20), and the checkpoint cycle of
# --ckpt-every 5 (five writes, six with the resume to 24 steps: 83 GB at
# full size) runs through the same CLI with --smoke
TRAIN_ARCH, TRAIN_B, TRAIN_SEQ = "granite-moe-1b-a400m", 8, 128
TRAIN_STEPS, TRAIN_RESUME, TRAIN_EVERY = 20, 24, 5
# (qwen2-0.5b's timed steps cut from 10 to 6 to fit the call's time)
DENSE_ARCH, DENSE_STEPS, DENSE_MB, DENSE_REMAT = "qwen2-0.5b", 6, 2, "dots"
# steps timed with the device synchronised (the first is cold)
TRAIN_TIMED = 6
# the f32 cross-check: full width, 2 layers, batch 2, seq 64, TF32 off
TRAIN_XCHECK = (2, 2, 64)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-5, 1e-4


def _train_argv(steps, ckpt_dir, *extra):
    return ["--arch", TRAIN_ARCH, "--device", "cuda", "--steps", str(steps),
            "--batch", str(TRAIN_B), "--seq", str(TRAIN_SEQ), "--ckpt-dir",
            str(ckpt_dir), *extra]


def _check_losses(what, losses, n, falls=False):
    """``n`` finite losses and, with ``falls``, the last below the
    first."""
    _require(len(losses) == n and all(math.isfinite(x) for x in losses),
             f"{what}: losses {losses}, want {n} finite ones")
    _require(not falls or losses[-1] < losses[0],
             f"{what}: last loss {losses[-1]} not below the first "
             f"{losses[0]}")


def _run_cli(fn, argv):
    """``fn(argv)`` (``train.run`` or ``train.main``) in process, its
    print captured and echoed; returns (its result, the print, s)."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        got = fn(argv)
    wall = time.perf_counter() - t0
    print(buf.getvalue(), end="")
    return got, buf.getvalue(), wall


def _check_resumed(what, out, losses, n):
    _require(f"resumed from step {TRAIN_STEPS}\n" in out
             and "done: first loss" in out and len(losses) == n
             and all(math.isfinite(x) for x in losses),
             f"{what}: {out!r}")


def _train_cli(dev, card, _build):
    """``repro_torch.launch.train`` in process on granite at full size:
    20 steps (``run``: every loss finite, exactly 24 top-k launches a
    step; on 20 fresh batches at lr 3e-4 the loss is noise, so whether it
    falls is printed, and :func:`_train_timed` requires it to fall on a
    repeated batch), its checkpoint of step 20
    restored onto the card equal to the trained state bit for bit; then
    the checkpoint cycle with ``--ckpt-every 5 --smoke``: checkpoints 10,
    15 and 20 left after 20 steps (keep 3 across the forced re-save of
    step 20: the port's repair of reference fault 3), then ``main`` to 24
    steps, which must resume from step 20 and leave 15, 20 and 24 (the
    resume at smoke size only: at full size it wrote and read 28 GB more,
    cut for time).  Returns the first call's launches."""
    import shutil
    import torch
    from repro_torch.ckpt import checkpoint as C
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        _build.reset_launches()          # count the CLI's run alone
        (losses, state), _, wall = _run_cli(
            train.run, _train_argv(TRAIN_STEPS, ckpt))
        launches = dict(_build.LAUNCHES)
        _check_losses("train CLI", losses, TRAIN_STEPS)
        cfg = get_config(TRAIN_ARCH)
        want = {"topk": cfg.n_layers * TRAIN_STEPS, "topk_select": 0,
                "merge": 0}
        got = {k: launches[k] for k in want}
        _require(got == want, f"train CLI: launches {got}, want {want}")
        kept = C._finished(str(ckpt))
        _require(kept == [TRAIN_STEPS], f"train CLI: checkpoints {kept}")
        t1 = time.perf_counter()
        lm = M.init_params(torch.Generator(dev).manual_seed(1), cfg,
                           max_seq=TRAIN_SEQ, device=dev)
        restored = C.restore(str(ckpt), TRAIN_STEPS,
                             (lm, adamw_init(lm, AdamWConfig())), device=dev)
        a, b = [], []
        C._flatten(state, a)
        C._flatten(restored, b)
        _require(len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b)),
                 "train CLI: the restored step 20 != the trained state")
        restore_s = time.perf_counter() - t1
        nbytes = sum(_nbytes(x) for x in a)
        del state, restored, lm, a, b
        _free_card()
        shutil.rmtree(ckpt)
        cycle = ("--ckpt-every", str(TRAIN_EVERY), "--smoke")
        _run_cli(train.main, _train_argv(TRAIN_STEPS, ckpt, *cycle))
        kept3 = C._finished(str(ckpt))
        _require(kept3 == [10, 15, 20], f"train CLI --ckpt-every "
                 f"{TRAIN_EVERY} --smoke: checkpoints {kept3}, want "
                 "[10, 15, 20]")
        losses4, out, _ = _run_cli(train.main, _train_argv(
            TRAIN_RESUME, ckpt, *cycle))
        _check_resumed("train CLI --smoke resume", out, losses4,
                       TRAIN_RESUME - TRAIN_STEPS)
        kept4 = C._finished(str(ckpt))
        _require(kept4 == [15, 20, 24], f"train CLI --smoke resume: "
                 f"checkpoints {kept4}, want [15, 20, 24]")
        res = {"losses": losses, "last_below_first": losses[-1] < losses[0],
               "smoke_resumed_losses": losses4, "main_s": wall,
               "restore_check_s": restore_s,
               "checkpoint_bytes": nbytes, "kept": kept,
               "smoke_cycle_kept": kept3,
               "smoke_cycle_kept_after_resume": kept4,
               "launches": launches}
        print("[train] CLI " + json.dumps(res) + f"; {card}")
        return launches
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def _train_profile(step):
    """One profiler window of one call of ``step``: its kernels (markers
    left out), their device time, the union of their intervals and the
    six kernels that take the most device time."""
    kernels = [(ts, dur, name) for _, name, ts, dur in _trace_kernels(
        _profiled(step))[0] if name != _MARKER]
    by_name = {}
    for _, dur, name in kernels:
        by_name[name] = by_name.get(name, 0.0) + dur / 1e3
    ivs = sorted((ts, ts + dur) for ts, dur, _ in kernels)
    busy, end = 0.0, -math.inf
    for a, b in ivs:                     # the union of kernel intervals
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return {"kernels": len(kernels),
            "device_ms": sum(d for _, d, _ in kernels) / 1e3,
            "busy_ms": busy / 1e3,
            "span_ms": (ivs[-1][1] - ivs[0][0]) / 1e3 if ivs else None,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:6]}


def _train_timed(dev, card, arch, microbatches, remat, steps, router=None):
    """``launch.train.build`` at full size on the card and ``steps``
    train steps on one repeated batch (step 0's), each synchronised:
    losses finite and the last below the first (the model fits the
    batch it sees again); a step's ms (the mean of the warm ones) and
    tokens/s, ``max_memory_allocated``, then one profiler window of one
    step (kernels, device ms, idle share of the synchronised step) and
    one of ``adamw_update`` alone.  With ``router``, granite's router
    checks (:func:`_train_router`).  Returns the numbers."""
    import torch
    from repro_torch.data.pipeline import device_put_batch
    from repro_torch.launch import train
    from repro_torch.optim.adamw import AdamWConfig, adamw_update, decayed
    _free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    what = f"train {arch}"
    t0 = time.perf_counter()
    cfg, _, params, opt, step_fn, data = train.build(
        arch, smoke=False, batch=TRAIN_B, seq=TRAIN_SEQ, model_par=1,
        microbatches=microbatches, remat=remat, lr=3e-4, steps=steps,
        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses, step_s = [], []
    batch = device_put_batch(data.batch_at(0), dev)
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
    _check_losses(what, losses, steps, falls=True)
    warm = step_s[1:]
    step_ms = statistics.fmean(warm) * 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    prof = _train_profile(lambda: step_fn(params, opt, batch))
    prof["idle_share_of_synced_step"] = 1 - prof["busy_ms"] / step_ms
    # the optimizer's share: adamw_update alone on zero gradients
    grads = {n: torch.zeros_like(p) for n, p in params.named_parameters()}
    decay = decayed(params, cfg)
    prof["adamw_update"] = _train_profile(lambda: adamw_update(
        grads, opt, params, AdamWConfig(), decay))
    del grads
    res = {"microbatches": microbatches, "remat": remat,
           "init_s": init_s, "losses": losses, "step_s": step_s,
           "step_ms_mean_warm": step_ms,
           "tokens_per_s": TRAIN_B * TRAIN_SEQ / (step_ms / 1e3),
           "profile": prof,
           "max_memory_allocated": peak}
    print(f"[{what}] {cfg.n_layers} layers, batch {TRAIN_B}, seq "
          f"{TRAIN_SEQ} " + json.dumps(res) + f"; {card}")
    if router is not None:
        res["router"] = router(cfg, params, opt, step_fn, data)
    del params, opt
    _free_card()
    return res


def _train_router(dev, errs, _build):
    """granite's router in training: one step's 24 router calls
    captured at (1,024, 32), k = 8, the kernel bit-equal to
    ``topk_ref`` on each; the top-k autograd function's input gradient
    bit-equal to the scatter of one upstream gradient; exactly 24
    top-k launches a step without remat and 48 under ``remat="full"``
    (and ``"dots"``), which recompute each router.  Returns layer 0's
    probabilities and k."""
    import torch
    from repro_torch.data.pipeline import device_put_batch
    from repro_torch.kernels.topk import topk_cuda, topk_ref, \
        topk_with_grad
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.steps import make_train_step

    def check(cfg, params, opt, step_fn, data):
        batch = device_put_batch(data.batch_at(0), dev)
        with _router_probs() as seen:
            step_fn(params, opt, batch)
        n = cfg.n_layers
        _require(len(seen) == n and all(
            tuple(p.shape) == (TRAIN_B * TRAIN_SEQ, cfg.moe.n_experts)
            and k == cfg.moe.top_k for p, k in seen),
            f"train router: {len(seen)} calls, want {n} of "
            f"({TRAIN_B * TRAIN_SEQ}, {cfg.moe.n_experts})")
        for probs, k in seen:
            v1, i1 = topk_cuda(probs, k)
            v2, i2 = topk_ref(probs.cpu(), k)
            errs["topk"] = max(errs["topk"], _max_abs_err(v1.cpu(), v2))
            _require(_same(v1.cpu(), v2) and _same(i1.cpu(), i2),
                     f"train router top-k at {tuple(probs.shape)}: kernel "
                     "!= topk_ref")
        k = cfg.moe.top_k
        x = seen[0][0].clone().requires_grad_(True)
        v, i = topk_with_grad(x, k)
        g = torch.randn(v.shape, generator=torch.Generator(dev).manual_seed(3),
                        device=dev)
        (gx,) = torch.autograd.grad(v, x, g)
        _require(_same(gx, torch.zeros_like(x).scatter(-1, i.long(), g)),
                 "train router: the top-k's gradient != the scatter")
        counts = {}
        for remat in ("none", "full", "dots"):
            fn = make_train_step(cfg, AdamWConfig(), remat=remat)
            _build.reset_launches()
            fn(params, opt, batch)
            torch.cuda.synchronize()
            counts[remat] = _build.LAUNCHES["topk"]
        want = {"none": n, "full": 2 * n, "dots": 2 * n}
        _require(counts == want, f"train router: top-k launches a step "
                 f"{counts}, want {want}")
        print(f"[train router] {len(seen)} router top-k calls a step on the "
              f"card == topk_ref bit for bit at {tuple(seen[0][0].shape)} "
              f"k = {k} (smallest k-th / (k+1)-th gap "
              f"{_router_margin(seen)}); the autograd function's input "
              f"gradient == the scatter, bit for bit; top-k launches a step "
              + json.dumps(counts))
        return seen[0]
    return check


def _train_xcheck(dev, arch, errs):
    """``arch`` at full width and 2 layers in f32 with TF32 off:
    ``loss_fn`` and the gradient of every parameter on the card against
    the port's CPU path on the same weights (drawn on the card, copied
    to the host) and the same SyntheticLM batch (2 x 64): the loss
    within rtol 1e-5, each gradient's relative L2 error at most 1e-4;
    the smallest router gap printed for MoE."""
    import copy
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM, device_put_batch
    from repro_torch.models import model as M
    layers, batch, seq = TRAIN_XCHECK
    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              param_dtype="float32",
                              compute_dtype="float32")
    t0 = time.perf_counter()
    card = M.init_params(torch.Generator(dev).manual_seed(0), cfg,
                         max_seq=seq, device=dev)
    host = copy.deepcopy(card).to("cpu")
    raw = SyntheticLM(cfg.vocab_size, seq, batch, seed=4).batch_at(0)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        outs, routed = [], []
        for params, d in ((card, dev), (host, "cpu")):
            with _router_probs() as seen:
                loss, aux = M.loss_fn(params, cfg, device_put_batch(raw, d))
                names, leaves = zip(*params.named_parameters())
                grads = torch.autograd.grad(loss, leaves)
            outs.append((float(loss.detach()),
                         {k: float(v.detach()) for k, v in aux.items()},
                         {n: g.detach().cpu().double()
                          for n, g in zip(names, grads)}))
            routed.append(seen)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    margin = _router_margin(routed[1]) if routed[1] else None
    (l_card, m_card, g_card), (l_cpu, m_cpu, g_cpu) = outs
    rel = {n: float((g_card[n] - g).norm() / g.norm().clamp_min(1e-30))
           for n, g in g_cpu.items()}
    worst = dict(sorted(rel.items(), key=lambda kv: -kv[1])[:6])
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    _require(loss_err <= TRAIN_LOSS_RTOL and max(rel.values())
             <= TRAIN_GRAD_RTOL,
             f"train {arch} cross-check: loss {l_card} vs {l_cpu} (rel "
             f"{loss_err}), worst gradients {worst}, router margin "
             f"{margin}")
    errs[f"train_{arch}"] = max(rel.values())
    print(f"[train {arch}] full width, {layers} layers, batch {batch}, seq "
          f"{seq}, f32, TF32 off: loss {l_card} (card) vs {l_cpu} (CPU "
          f"path), rel {loss_err}; {m_card} vs {m_cpu}; {len(rel)} "
          f"gradients within relative L2 {TRAIN_GRAD_RTOL}, largest "
          + json.dumps(worst)
          + ("" if margin is None else f"; router margin {margin}")
          + f" ({time.perf_counter() - t0:.3f} s)")


def _train(dev, card, errs, _build):
    """Phase 14: the training CLI on granite-moe-1b-a400m at full size
    with checkpoints, resume and the bit-equal restore
    (:func:`_train_cli`); granite (the CLI's settings, with the router
    checks of :func:`_train_router`) and qwen2-0.5b (2 microbatches,
    remat "dots") timed and profiled (:func:`_train_timed`); both held
    in f32 to the CPU path (:func:`_train_xcheck`).  Returns (launches
    of the CLI's run, (layer 0's router probabilities of one step, k))."""
    t0 = time.perf_counter()
    launches = _train_cli(dev, card, _build)
    _free_card()
    took = {"cli": time.perf_counter() - t0}
    t0 = time.perf_counter()
    res = _train_timed(dev, card, TRAIN_ARCH, 1, "none", TRAIN_TIMED,
                       router=_train_router(dev, errs, _build))
    took[f"timed {TRAIN_ARCH}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _train_timed(dev, card, DENSE_ARCH, DENSE_MB, DENSE_REMAT, DENSE_STEPS)
    took[f"timed {DENSE_ARCH}"] = time.perf_counter() - t0
    for arch in (TRAIN_ARCH, DENSE_ARCH):
        t0 = time.perf_counter()
        _train_xcheck(dev, arch, errs)
        _free_card()
        took[f"f32 check {arch}"] = time.perf_counter() - t0
    print("[phase 14] seconds by part " + json.dumps(took))
    return launches, res["router"]


# ---------------------------------------------------------------------------
# phase 15: FD across processes on the card
# ---------------------------------------------------------------------------

# gloo ranks sharing the card (NCCL refuses two ranks on one card): the
# device path at phase 5's full width as 4 ranks x 16 local peers, and
# optim/compress.py's mean over the ranks as 4 pods at qwen2-0.5b's full
# parameter tree (the reference's k_frac default, the p_drop of
# examples/grad_compression.py, each rank's noise 0.3 beside a shared
# unit normal part, so that most winners are chosen by 3 or 4 pods)
RANKS = 4
RANK_ARCH = "qwen2-0.5b"
RANK_SEED = 15
RANK_K_FRAC = 1e-3
RANK_P_DROP = 0.05
RANK_NOISE = 0.3
RANK_TIMEOUT = 600


def _rank_leaf(dev, shape):
    """The largest leaf's magnitudes as rank 0 selects them in round 1
    (the first leaf drawn: the tied embedding), for phase 6."""
    import torch
    shared = torch.Generator(device=dev)
    shared.manual_seed(RANK_SEED + 100)
    own = torch.Generator(device=dev)
    own.manual_seed(RANK_SEED + 101)
    g = torch.randn(shape, generator=shared, device=dev)
    g.add_(torch.randn(shape, generator=own, device=dev), alpha=RANK_NOISE)
    return g.abs().reshape(1, -1)


def _ranks(dev, card, _build):
    """Phase 15: spawn the ranks (``tools/chip_ranks.py``), which fail
    the phase by raising; check that every rank's g_hat digests agree,
    print the bytes each call delivered across ranks beside the paper's
    model, and return (the launches summed over ranks, the compressed
    tree's largest leaf (name, shape, k))."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core import fd
    from repro_torch.launch.ranks import spawn_ranks
    from repro_torch.models import model as LM
    sys.path.insert(0, str(ROOT / "tools"))
    import chip_ranks
    cfg = get_config(RANK_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = LM.init_params(gen, cfg)
    leaves = [(name, tuple(p.shape)) for name, p in params.named_parameters()]
    del params
    _free_card()
    conf = dict(peers=DEV_PEERS, local=DEV_LOCAL, k=DEV_K,
                k_large=DEV_K_LARGE, batch=DEV_B, d=DEV_D, seed=RANK_SEED,
                leaves=leaves, noise=RANK_NOISE, k_frac=RANK_K_FRAC,
                p_drop=RANK_P_DROP)
    t0 = time.perf_counter()
    outs = spawn_ranks(chip_ranks.run, RANKS, args=(conf,),
                       timeout=RANK_TIMEOUT)
    secs = time.perf_counter() - t0
    launches = {name: 0 for name in _build.LAUNCHES}
    for r, o in enumerate(outs):
        d, c = o["device"], o["compress"]
        for counts in [d["launches"]] + c["launches"]:
            for name, n in counts.items():
                launches[name] += n
        print(f"[ranks] rank {r}: {o['seconds']:.3f} s in all, "
              f"max_memory_allocated {o['max_memory_allocated']} B; device path "
              f"{d['path_s']:.3f} s, launches {json.dumps(d['launches'])}, "
              f"run_s {json.dumps(d['run_s'])}; compressed mean rounds "
              f"{json.dumps(c['seconds'])} s, launches "
              f"{json.dumps(c['launches'])}")
    _require(all(o["compress"]["digests"] == outs[0]["compress"]["digests"]
                 for o in outs), "the ranks' g_hat differ")
    L = outs[0]["device"]["L"]
    sent = {key: sum(o["device"]["sent_bytes"][key] for o in outs)
            for key in outs[0]["device"]["sent_bytes"]}
    model = {f"{pol}/{sch}/run_many": DEV_B * fd.comm_bytes(
        alg, DEV_PEERS, DEV_LOCAL, DEV_K,
        schedule="halving" if sch == "-" else sch)
        for pol, alg, sch in (("fd-dynamic", "fd", "halving"),
                              ("fd-dynamic", "fd", "doubling"),
                              ("fd-dynamic", "fd", "ring"),
                              ("cn", "cn", "-"), ("cn-star", "cn_star", "-"))}
    print(f"[ranks] bytes delivered across the {RANKS} ranks ({L} peers a "
          f"rank, {DEV_B} queries a call) " + json.dumps(sent)
          + f"; the paper's model over all {DEV_PEERS} peers "
          + json.dumps(model))
    from repro_torch.optim.compress import compression_ratio
    c = outs[0]["compress"]
    sent_c = [sum(o["compress"]["sent_bytes"][i] for o in outs)
              for i in range(2)]
    emb = c["embedding"]
    emb_ratio = compression_ratio(math.prod(emb["shape"]), emb["k"], RANKS)
    print(f"[ranks] compressed mean of {RANK_ARCH}'s tree over {RANKS} "
          f"pods: {c['leaves']} leaves, {c['n']} entries, k {c['k']} in "
          f"all (largest leaf {json.dumps(c['embedding'])}, "
          f"{c['three_or_more']} of its indices chosen by 3 or more pods); "
          f"k-list bytes sent by each rank a round "
          f"{[o['compress']['sent_bytes'] for o in outs]} (model "
          f"{c['list_bytes']}), all ranks {sent_c}; a dense ring "
          f"all-reduce {c['dense_bytes']:.0f} a rank; ratio "
          f"{c['dense_bytes'] / c['list_bytes']:.1f} (compression_ratio of "
          f"{emb['name']} {emb_ratio:.1f}); error feedback L1 "
          f"{c['ef_l1']}; g_hat and ef == topk_ref's on every rank, "
          f"g_hat the same on every rank")
    print(f"[phase 15] {RANKS} gloo ranks on {card}: {secs:.3f} s "
          "(the ranks time-share one card)")
    return launches, (emb["name"], tuple(emb["shape"]), emb["k"])


# ---------------------------------------------------------------------------
# phase 17: the dry run's counter held to the card
# ---------------------------------------------------------------------------

# phase 14's training cell and phase 11's decode; the fake trace's peak
# against max_memory_allocated (relative; readings on an H100 80GB HBM3
# at 700 W: 5.4e-7 for the granite step, 6.3e-4 for the decode);
# synchronised steps timed
P17_TRAIN = ("granite-moe-1b-a400m", 8, 128)
P17_PEAK_TOL = 0.01
P17_TRAIN_STEPS, P17_DECODE_STEPS = 3, 15
# the dry run's subprocesses (each process reaches the card in ~8 s)
P17_LIMIT_S = 600
# a smoke-size granite train cell on the 256-rank fake world, on fake
# card tensors: a backward a torch without CUDA cannot trace
P17_SMOKE_TRAIN = """
import json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
sys.path.insert(0, "tools")
import chip_train_ranks
from repro_torch.configs.base import ShapeConfig, get_config, smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.train import place_blocks
cfg = smoke_config(get_config("granite-moe-1b-a400m"))
rec = D.trace_cell(cfg, ShapeConfig("train_small", 64, 32, "train"),
                   overrides={"microbatches": 2})
card = torch.device("cuda", 0)
with D._fake_world(256) as group, FakeTensorMode():
    mesh = make_production_mesh(group=group, device=card)
    params = D._init_params(cfg, 4096, card)
    specs = place_blocks(params, cfg, mesh)
    rec["predicted_bytes"] = chip_train_ranks.predicted_bytes(
        params, specs, mesh, microbatches=2, cfg=cfg, rows=32 // 16,
        seq=64, remat="full")
print(json.dumps(rec))
"""


def _p17_totals(what, fake, real, launches):
    """The fake and the real trace of one step: equal FLOPs, bytes and
    kernel calls, the calls equal to the launches."""
    calls = {"topk": launches["topk"] + launches["topk_select"],
             "merge": launches["merge"]}
    calls = {k: n for k, n in calls.items() if n}
    diff = {op: (fake.op_counts.get(op, 0), real.op_counts.get(op, 0))
            for op in set(fake.op_counts) | set(real.op_counts)
            if fake.op_counts.get(op, 0) != real.op_counts.get(op, 0)
            and not op.startswith("prim.")}      # metadata: fake only
    _require((fake.flops, fake.bytes_accessed) == (real.flops,
                                                   real.bytes_accessed),
             f"{what}: fake flops / bytes {fake.flops} / "
             f"{fake.bytes_accessed}, real {real.flops} / "
             f"{real.bytes_accessed}; ops (fake, real) that differ {diff}")
    _require(fake.kernels == real.kernels == calls,
             f"{what}: kernel calls fake {fake.kernels} real "
             f"{real.kernels}, launches {launches}")


def _p17_peak(what, fake, base, max_alloc):
    """The fake trace's peak against the card's: the fake's temporaries
    on top of what the card held before the step."""
    predicted = base + fake.peak_device_bytes - fake.argument_bytes
    err = abs(predicted - max_alloc) / max_alloc
    _require(err <= P17_PEAK_TOL,
             f"{what}: predicted peak {predicted} B, max_memory_allocated "
             f"{max_alloc} B ({err:.1%})")
    return {"fake_argument_bytes": fake.argument_bytes,
            "fake_peak_bytes": fake.peak_device_bytes,
            "allocated_before": base, "predicted_peak": predicted,
            "max_memory_allocated": max_alloc, "peak_err": err}


def _p17_measured(dev, fn, reps):
    """Synchronised calls of ``fn``, each timed (s)."""
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        out.append(time.perf_counter() - t0)
    return out


def _p17_bound(cfg, shape, totals, step_s):
    from repro_torch.roofline.analysis import (HW, model_flops_estimate,
                                               roofline_terms)
    terms = roofline_terms(
        hlo_flops=totals.flops, hlo_bytes=totals.bytes_accessed,
        collective_bytes=totals.collective_bytes, hw=HW(),
        model_flops=model_flops_estimate(cfg, shape, mode=shape.kind))
    return {"flops": totals.flops, "bytes": totals.bytes_accessed,
            "ops": totals.ops, "bound_ms": terms["bound_s"] * 1e3,
            "dominant": terms["dominant"], "step_ms": step_s * 1e3,
            "share_of_bound": terms["bound_s"] / step_s}


def _p17_train(dev, card, _build):
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.mesh import Mesh
    from repro_torch.data.pipeline import device_put_batch
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.train import build
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.roofline.trace import analyze
    from repro_torch.runtime.steps import make_train_step
    arch, batch, seq = P17_TRAIN
    cfg, mesh, params, opt, step_fn, data = build(
        arch, smoke=False, batch=batch, seq=seq, model_par=1,
        microbatches=1, remat="none", lr=3e-4, steps=20, device=dev)
    real_batch = device_put_batch(data.batch_at(0), mesh)
    opt_cfg = AdamWConfig(lr=3e-4, total_steps=20, warmup_steps=1)
    with FakeTensorMode():
        fparams = D._init_params(cfg, max(seq, 128), dev)
        fopt = adamw_init(fparams, opt_cfg)
        fstep = make_train_step(cfg, opt_cfg, microbatches=1, remat="none",
                                mesh=Mesh((1, 1), ("data", "model"), dev))
        fbatch = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
                  for k, v in real_batch.items()}
        fake = analyze(fstep, fparams, fopt, fbatch)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    _build.reset_launches()
    real = analyze(step_fn, params, opt, real_batch)
    torch.cuda.synchronize(dev)
    launches = dict(_build.LAUNCHES)
    max_alloc = torch.cuda.max_memory_allocated(dev)
    _p17_totals("phase 17 train", fake, real, launches)
    _require(launches["topk"] == cfg.n_layers,
             f"phase 17 train: {launches} launches, want {cfg.n_layers} "
             f"top-k")
    res = _p17_peak("phase 17 train", fake, base, max_alloc)
    steps = _p17_measured(dev, lambda: step_fn(params, opt, real_batch),
                          P17_TRAIN_STEPS)
    res.update(_p17_bound(cfg, ShapeConfig("p17", seq, batch, "train"),
                          fake, statistics.median(steps)))
    res.update(launches=launches, step_s=steps)
    print(f"[phase 17] train {arch} batch {batch} seq {seq}: "
          + json.dumps(res) + f"; {card}")
    return launches


def _p17_decode(dev, card, _build):
    import numpy as np
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import state_from_prefill
    from repro_torch.models import model as M
    from repro_torch.roofline.trace import analyze
    from repro_torch.runtime.steps import gumbel, make_serve_step
    cfg = get_config(DEC_ARCH)
    s_max = DEC_PROMPT + DEC_GEN
    params = M.init_params(torch.Generator(dev).manual_seed(0), cfg,
                           max_seq=s_max, device=dev)
    batch = _decode_batch(cfg, np.random.default_rng(0), DEC_B, dev)
    step = make_serve_step(cfg, make_host_mesh(DEC_P, device=dev, cfg=cfg),
                           k=DEC_K)
    last, pst = M.prefill(params, cfg, batch)
    state = state_from_prefill(cfg, pst, s_max)
    tok = torch.argmax(last, dim=-1)[:, None].to(torch.int32)
    gen = torch.Generator(dev).manual_seed(1)
    noise = gumbel((DEC_B, DEC_K), gen)
    with FakeTensorMode():
        fparams = D._init_params(cfg, s_max, dev)
        fstep = make_serve_step(
            cfg, make_host_mesh(DEC_P, device=dev, cfg=cfg), k=DEC_K)
        fstate = M.init_decode_state(
            cfg, batch=DEC_B, s_max=s_max, cache_dtype=torch.float32,
            device=dev)._replace(pos=state.pos)
        fake = analyze(fstep, fparams, fstate,
                       torch.zeros(tok.shape, dtype=tok.dtype, device=dev),
                       None, torch.zeros(noise.shape, device=dev))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    _build.reset_launches()
    real = analyze(step, params, state, tok, None, noise)
    torch.cuda.synchronize(dev)
    launches = dict(_build.LAUNCHES)
    max_alloc = torch.cuda.max_memory_allocated(dev)
    _p17_totals("phase 17 decode", fake, real, launches)
    _require(launches["topk"] == 1 and launches["merge"] == int(
        math.log2(DEC_P)), f"phase 17 decode: {launches}")
    res = _p17_peak("phase 17 decode", fake, base, max_alloc)
    box = {"state": state_from_prefill(cfg, pst, s_max), "tok": tok}

    def one():
        box["tok"], box["state"] = step(params, box["state"], box["tok"],
                                        gen)
    steps = _p17_measured(dev, one, P17_DECODE_STEPS)
    res.update(_p17_bound(cfg, ShapeConfig("p17", s_max, DEC_B, "decode"),
                          fake, statistics.fmean(steps[1:])))
    res.update(launches=launches, step_s=steps,
               step_ms_pr24=28.58938078571782)
    print(f"[phase 17] decode {cfg.name} batch {DEC_B}, {DEC_P} peers: "
          + json.dumps(res) + f"; {card}")
    return launches


def _p17_dryrun_start():
    """The dry run's CLI on a full-size decode cell and a smoke train
    cell on fake card tensors, each a process, side by side: started
    (beside phase 10's work on the card; they trace on fake tensors) and
    returned; :func:`_p17_dryrun` waits for them and checks them."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1.5-0.5b", "--shape", "decode_32k"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    smoke = subprocess.Popen(
        [sys.executable, "-c", P17_SMOKE_TRAIN], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return cli, smoke


def _p17_dryrun(procs):
    """Wait for :func:`_p17_dryrun_start`'s processes and check them."""
    from repro_torch.launch.dryrun import DEFAULT_OUT
    cli, smoke = procs
    try:
        cli_log, _ = cli.communicate(timeout=P17_LIMIT_S)
        smoke_log, _ = smoke.communicate(timeout=P17_LIMIT_S)
    finally:
        for proc in (cli, smoke):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    _require(cli.returncode == 0,
             f"phase 17: the dry run's CLI exited {cli.returncode}:\n"
             f"{cli_log[-3000:]}")
    _require(smoke.returncode == 0,
             f"phase 17: the smoke train cell exited {smoke.returncode}:"
             f"\n{smoke_log[-3000:]}")
    rec = json.loads((ROOT / DEFAULT_OUT
                      / "qwen1.5-0.5b__decode_32k__sp.json").read_text())
    _require(rec["device"] == "cuda" and rec["kernels"] == {
        "topk": 1, "merge": 4}, f"phase 17 dry run: {rec['device']} "
        f"{rec['kernels']}")
    # the decode state laid out with each cache's sequence over the 16
    # model ranks: the rank holds what decode_state_specs places
    _require(rec["memory"]["cache_gib"] == rec["memory"]["specs_cache_gib"],
             f"phase 17 dry run: caches {rec['memory']}")
    train = json.loads(smoke_log.strip().splitlines()[-1])
    _require(train["device"] == "cuda" and train["kernels"].get("topk", 0)
             > 0 and train["sent_bytes"] == train["predicted_bytes"],
             f"phase 17 smoke train cell: {train['device']} "
             f"{train['kernels']} sent {train['sent_bytes']} predicted "
             f"{train['predicted_bytes']}")
    keep = ("t_trace_s", "device", "kernels", "flops", "hlo_bytes",
            "sent_bytes", "memory", "roofline")
    print("[phase 17] dry run " + cli_log.strip().splitlines()[0])
    print("[phase 17] dry run record "
          + json.dumps({k: rec[k] for k in keep}))
    print("[phase 17] smoke train cell "
          + json.dumps({k: train[k] for k in keep + ("predicted_bytes",)}))


def _p17_tp_fake(dev):
    """The fake trace of rank 0's (2, 2) train step over a fake world of
    4 ranks, phase 16's first layout (kept in ``TR_FAKE`` for phase 16's
    real trace)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs.base import get_config
    from repro_torch.core.mesh import Mesh
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.train import place_blocks
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.roofline.trace import analyze
    from repro_torch.runtime.steps import make_train_step
    cfg = get_config(TR_ARCH)
    t0 = time.perf_counter()
    with D._fake_world(RANKS) as group, FakeTensorMode():
        mesh = Mesh((2, 2), ("data", "model"), dev, group=group,
                    ranks=(2, 2))
        params = D._init_params(cfg, max(TRAIN_SEQ, 128), dev)
        specs = place_blocks(params, cfg, mesh)
        opt_cfg = AdamWConfig(lr=3e-4, total_steps=TR_STEPS[(2, 2)],
                              warmup_steps=1)
        step = make_train_step(cfg, opt_cfg, remat="none", mesh=mesh,
                               specs=specs)
        rows = TRAIN_B // 2
        batch = {k: torch.zeros((rows, TRAIN_SEQ), dtype=torch.int32,
                                device=dev) for k in ("tokens", "labels")}
        TR_FAKE["totals"] = analyze(step, params, adamw_init(params,
                                                             opt_cfg),
                                    batch, device=dev.type)
    print(f"[phase 17] fake trace of a (2, 2) {TR_ARCH} train step as rank "
          f"0 of a fake 4-rank world: {time.perf_counter() - t0:.3f} s")


def _dryrun_phase(dev, card, _build):
    t0 = time.perf_counter()
    _p17_train(dev, card, _build)
    _free_card()
    _p17_decode(dev, card, _build)
    _free_card()
    _p17_tp_fake(dev)
    print(f"[phase 17] {time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------------------
# phase 16: training and serving across ranks on the card
# ---------------------------------------------------------------------------

# 4 gloo ranks sharing the card, one peer a rank, as (data 2, model 2)
# and (data 1, model 4), the products split over the model ranks:
# granite-moe-1b-a400m trained at full size (phase 14's batch and seq),
# the same arch at full width and 2 layers in f32 against one process
# over a mesh of virtual peers of each shape (phase 14's tolerance: loss
# rtol 1e-5, the norm's and each parameter's relative L2 error after the
# update 1e-4) and the (2, 2) checkpoint restored onto 2 ranks and onto
# one process bit for bit; then serve decode of qwen2-0.5b and granite
# at full size over (2, 2) and (1, 4), phase 11's command with the 16
# vocabulary peers spread over the model ranks, in f32 against the
# one-process decode on the same mesh shape (and at (2, 2) in bf16),
# each cache's sequence (S_max 48) cut over the model ranks; then three
# families over (1, 4) in f32 at full width and cut depth
# (``TR_WIDE``), against one process
TR_ARCH, TR_XCHECK_LAYERS = "granite-moe-1b-a400m", 2
TR_LAYOUTS = ((2, 2), (1, 4))
#: steps at each layout ((2, 2) cut from 3 to 2 to fit the call's time)
TR_STEPS = {(2, 2): 2, (1, 4): 2}
TR_DECODE_ARCHS = ("qwen2-0.5b", "granite-moe-1b-a400m")
#: the decodes of the other cache families over (1, 4), one vocabulary
#: peer a rank, f32, full width, cut depth (config changes): the window
#: (one mixer group, phase 13's 2,080-token prompt: the 2,048-slot ring
#: wraps), MLA (2 of 62 layers), the encoder-decoder (2 + 2 of 32 + 32
#: layers; its 1,500 frames divide 4, so the cross caches are cut too)
TR_WIDE = {"recurrentgemma-2b": {"n_layers": 3},
           "minicpm3-4b": {"n_layers": 2},
           "whisper-large-v3": {"n_layers": 2, "n_encoder_layers": 2}}
#: the config-dtype decode over ranks: each rank's logits block may lie
#: at most this many times as far (L2) from one process's as the
#: one-process logits lie from the next wider dtype (f32 for bf16) on
#: the same weights (their own rounding); a split that dropped or
#: misplaced a rank's part would lie about as far as the logits are
#: large
DEC_SPLIT_FACTOR = 3.0
TR_TIMEOUT = 600
#: phase 17's fake trace of rank 0's (2, 2) step, held to the real one
TR_FAKE = {}


def _ranks_decode_argv(arch, model_ranks=2):
    return _decode_argv(arch) + ["--model-ranks", str(model_ranks)]


def _wide_decode_argv(arch, smoke):
    """``TR_WIDE``'s decode of ``arch`` over (1, 4): one vocabulary peer
    a model rank, phase 13's prompt where it has one (40 tokens on the
    CPU path's smoke config, which wrap its 32-slot window)."""
    argv = _decode_argv(arch) + ["--model-par", "4", "--model-ranks", "4"]
    if arch in ARCH_PROMPT:
        argv += ["--prompt-len", str(40 if smoke else ARCH_PROMPT[arch])]
    return argv


def _same_digests(what, a, b):
    for part in ("params", "m", "v"):
        bad = [n for n in a[part] if a[part][n] != b[part][n]]
        _require(not bad and set(a[part]) == set(b[part]),
                 f"{what}: {part} differ bit-wise at {bad[:4]}")


def _first_diff(a, b):
    """The first decode step (column) where two token arrays differ, or
    None."""
    cols = [j for j in range(a.shape[1]) if (a[:, j] != b[:, j]).any()]
    return cols[0] if cols else None


def _decode_blocks(dev, argv, data_par, dtype=None, changes=None):
    """The decode of ``argv`` (``serve decode``'s flags) on one process,
    one of ``data_par`` data blocks of the batch at a time: each
    block's rows of the prompt (and of the stub frames) through
    ``prefill`` and ``make_serve_step`` over the ``--model-par`` virtual
    peers, with its rows of the whole batch's noise; the tokens of the
    blocks stacked.  What each data rank of the (2, 2) mesh computes, at
    the same batch size: the card's products round a row by the batch
    it is computed in.  ``dtype`` replaces the config's (TF32 off under
    f32), ``changes`` other fields of it."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.core.mesh import Mesh
    from repro_torch.data.pipeline import extra_model_inputs
    from repro_torch.launch.serve import _decode_args, state_from_prefill
    from repro_torch.models import model as M
    from repro_torch.runtime.steps import gumbel, make_serve_step
    args = _decode_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=dtype,
                                  compute_dtype=dtype)
    cfg = dataclasses.replace(cfg, **(changes or {}))
    s_max = args.prompt_len + args.gen
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = dtype is None and tf32
    try:
        params = M.init_params(torch.Generator(dev).manual_seed(0), cfg,
                               max_seq=s_max, device=dev)
        whole = extra_model_inputs(cfg, {"tokens": np.random.default_rng(
            0).integers(0, cfg.vocab_size, (args.batch, args.prompt_len)
                        ).astype(np.int32)})
        mesh = Mesh((1, args.model_par), ("data", "model"), dev)
        part = args.batch // data_par
        out = []
        for d in range(data_par):
            rows = slice(d * part, (d + 1) * part)
            last, pst = M.prefill(params, cfg, {
                k: torch.from_numpy(v[rows]).to(dev)
                for k, v in whole.items()})
            state = state_from_prefill(cfg, pst, s_max)
            tok = torch.argmax(last, dim=-1)[:, None].to(torch.int32)
            step = make_serve_step(cfg, mesh, k=args.k)
            gen = torch.Generator(dev).manual_seed(1)
            toks = [tok]
            for _ in range(args.gen - 1):
                noise = gumbel((args.batch, args.k), gen)[rows]
                tok, state = step(params, state, tok, None, noise=noise)
                toks.append(tok)
            out.append(torch.cat(toks, dim=1).cpu().numpy())
        return np.concatenate(out, axis=0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _check_train_layout(lay, tr, cfg, card):
    """(a) at one layout: the ranks' loss and norm bits, the replicas,
    the bytes by axis and the gathered parameter bytes against their
    reckonings; prints each rank's figures."""
    _require(all(t["losses"] == tr[0]["losses"]
                 and t["grad_norms"] == tr[0]["grad_norms"] for t in tr),
             f"train over ranks {lay}: the ranks' loss or norm bits differ")
    specs = tr[0]["specs"]
    for name, spec in specs.items():
        named = {a for e in spec if e is not None
                 for a in ((e,) if isinstance(e, str) else e)}
        for t in tr:
            for u in tr:
                # ranks that differ only on axes the spec leaves whole
                # (the model axis of a replicated leaf too) hold the same
                # block
                same = all(t["coord"][i] == u["coord"][i]
                           for i, a in enumerate(("data", "model"))
                           if a in named)
                _require(not same or t["digests"][name]
                         == u["digests"][name],
                         f"train over ranks {lay}: {name}'s replicas "
                         f"differ")
    for r, t in enumerate(tr):
        warm = t["step_s"][1:] or t["step_s"]
        print(f"[train ranks] {lay} rank {r} at (data, model) "
              f"{t['coord']}: build {t['build_s']:.3f} s, steps "
              f"{t['step_s']} s (warm mean {statistics.fmean(warm):.6f} "
              f"s); bytes delivered a step by axis {t['sent_bytes']} (the "
              f"reckoning {t['predicted_bytes']}; model-axis operands "
              f"{t['model_axis_operands']}); parameter bytes gathered a "
              f"step {t['gathered_bytes']} (the data-only reckoning "
              f"{t['reckoned_gather_bytes']}, whole parameters "
              f"{t['whole_param_bytes']}); max_memory_allocated "
              f"{t.get('max_memory_allocated')} B; top-k launches a step "
              f"{[c['topk'] for c in t['launches']]}; {card}")
        _require(all(b == t["predicted_bytes"] for b in t["sent_bytes"]),
                 f"train over ranks {lay}: rank {r} delivered "
                 f"{t['sent_bytes']} B a step, the reckoning "
                 f"{t['predicted_bytes']}")
        _require(all(g == t["reckoned_gather_bytes"]
                     for g in t["gathered_bytes"]),
                 f"train over ranks {lay}: rank {r} gathered "
                 f"{t['gathered_bytes']} B of parameters a step, the "
                 f"data-only reckoning {t['reckoned_gather_bytes']}")
    print(f"[train ranks] {TR_ARCH} at full size ({cfg.n_layers} "
          f"layers), batch {TRAIN_B}, seq {TRAIN_SEQ}, {lay} over "
          f"{RANKS} ranks: losses {tr[0]['losses']}, grad norms "
          f"{tr[0]['grad_norms']}, the same bits on every rank; each "
          f"leaf's replicas equal bit for bit; {card}")


def _check_xcheck_layout(lay, outs):
    """(b) at one layout: the f32 step over the ranks against one
    process."""
    x = outs[0]["xcheck"][lay]
    worst = dict(sorted(x["param_rel"].items(),
                        key=lambda kv: -kv[1])[:6])
    _require(all(o["xcheck"][lay]["loss"] == x["loss"]
                 and o["xcheck"][lay]["grad_norm"] == x["grad_norm"]
                 for o in outs)
             and x["loss_rel"] <= TRAIN_LOSS_RTOL
             and x["grad_norm_rel"] <= TRAIN_GRAD_RTOL
             and max(x["param_rel"].values()) <= TRAIN_GRAD_RTOL,
             f"train ranks cross-check {lay}: loss {x['loss']} vs "
             f"{x['one_loss']}, grad norm {x['grad_norm']} vs "
             f"{x['one_grad_norm']}, worst parameters {worst}")
    print(f"[train ranks] {lay}: full width, {TR_XCHECK_LAYERS} layers, "
          f"f32, TF32 off, one step: loss {x['loss']} (4 ranks) vs "
          f"{x['one_loss']} (one process, {lay} virtual), rel "
          f"{x['loss_rel']}; grad norm {x['grad_norm']} vs "
          f"{x['one_grad_norm']}, rel {x['grad_norm_rel']} (within "
          f"{TRAIN_GRAD_RTOL}); {len(x['param_rel'])} parameters within "
          f"relative L2 {TRAIN_GRAD_RTOL} after the update, largest "
          + json.dumps(worst))


def _check_moe_decode(dev, what, argv, got):
    """A MoE decode over the ranks in f32 (``got``: each rank's
    ``chip_train_ranks.decode_logits`` with its routers' log) against
    one process on the same weights, in f32 and in f64, its routers
    made to take the ranks' experts (``replay``): (a) every choice where
    one process would itself pick other experts than the ranks did is a
    tie, its margin in f64 (the k-th and the (k+1)-th probability's gap
    over the k-th) at most ``DEC_SPLIT_FACTOR`` times the margins' own
    f32 rounding (the largest f32-f64 difference of a margin in this
    run); (b) on those routes, each rank's logits blocks lie at most
    ``DEC_SPLIT_FACTOR`` times as far from one process's f32 columns as
    those lie from f64 (:func:`_check_decode_logits`).  Prints the
    margins."""
    import numpy as np
    sys.path.insert(0, str(ROOT / "tools"))
    import chip_train_ranks as CT
    ranks = [g["routes"][0] for g in got if not g["model_index"]]
    _require(len(ranks) == 1, f"decode {what}: one data rank expected")
    one = CT.decode_logits(argv, dev, dtype="float32", routes=True,
                           replay=ranks)
    _free_card()
    low, wide = one["routes"][0], one["wide"]["routes"][0]
    m32, m64 = CT.route_margins(low), CT.route_margins(wide)
    rounding = max(float(np.abs(a - b).max()) for a, b in zip(m32, m64))
    flips = {}
    for name, log in (("f32", low), ("f64", wide)):
        flips[name] = [(c, t, float(m64[c][t]))
                       for c, t in CT.route_flips(log, ranks[0])]
    ties = [f for fl in flips.values() for f in fl]
    print(f"[decode ranks] {what} f32 routers: {len(m64)} calls, "
          f"{sum(m.size for m in m64)} choices; smallest "
          f"f64 margin {min(float(m.min()) for m in m64)}, the margins' "
          f"f32 rounding {rounding}; choices one process, fed the "
          f"ranks' routes, would make otherwise (call, token, f64 "
          f"margin): f32 {flips['f32']}, f64 {flips['f64']} (gate: every "
          f"margin at most {DEC_SPLIT_FACTOR} x the rounding)")
    _require(all(m <= DEC_SPLIT_FACTOR * rounding for _, _, m in ties),
             f"decode {what} over ranks in f32: the ranks route other "
             f"experts than one process where no two nearly tie: {ties}")
    _check_decode_logits(what, got, one, "in f32 on the ranks' routes")


def _check_decode_logits(arch, got, one, how="in the config's dtype"):
    """Each rank's block of the logits the decode samples from
    (``chip_train_ranks.decode_logits``: the prompt's last logits and
    the first step's) against the one-process logits' columns of its
    block, for its rows (one process computing each data rank's rows
    apart, as it does): their L2 distance at most ``DEC_SPLIT_FACTOR``
    times the one-process logits' own rounding, their distance from the
    same computation in the next wider dtype (f32 for bf16, f64 for
    f32) on the same weights."""
    import numpy as np
    worst = {}
    for g in got:
        width = g["last"].shape[1]
        cols = slice(g["model_index"] * width,
                     (g["model_index"] + 1) * width)
        for key in ("last", "first"):
            low = one[key][g["rows"], cols]
            ref = one["wide"][key][g["rows"], cols]
            split = float(np.linalg.norm(g[key] - low))
            rnd = float(np.linalg.norm(low - ref))
            _require(np.isfinite(g[key]).all()
                     and split <= DEC_SPLIT_FACTOR * rnd,
                     f"decode {arch} over ranks: the {key} logits block "
                     f"of rank {g['rows'][0]}..{g['model_index']} is "
                     f"{split} from one process's (L2), whose own "
                     f"rounding is {rnd}")
            rel = split / float(np.linalg.norm(ref))
            w = worst.setdefault(key, [0.0, 0.0, 0.0])
            w[:] = max(w, [split / rnd, rel, rnd / float(np.linalg.norm(
                ref))])
    print(f"[decode ranks] {arch} {how} over the ranks: "
          f"each rank's logits block vs one process's columns, worst over "
          f"the ranks (L2 distance / the one-process logits' own rounding "
          f"vs the wider dtype, relative L2 distance, the rounding's "
          f"relative L2): "
          + json.dumps(worst) + f" (gate: the first at most "
          f"{DEC_SPLIT_FACTOR})")


def _check_tp_trace(outs, dev):
    """Rank 0's real trace of a (2, 2) step against phase 17's fake
    one (on the card; the CPU path, a check of this code, runs no
    phase 17)."""
    if dev.type != "cuda":
        return
    real = outs[0].get("trace")
    _require(real is not None and "totals" in TR_FAKE,
             "phase 16: rank 0's traced (2, 2) step or phase 17's fake "
             "trace of it is missing")
    fake = TR_FAKE["totals"]
    keys = ("flops", "bytes_accessed", "kernels", "coll_by_axis")
    got = {k: real[k] for k in keys}
    want = {k: getattr(fake, k) for k in keys}
    _require(got == want, f"TP step traces: real {got}, fake {want}")
    print("[phase 17] rank 0's (2, 2) train step over 4 gloo ranks, real "
          "trace == fake trace on a fake 4-rank world: "
          + json.dumps(got))


def _train_serve_ranks(dev, card, _build):
    """Phase 16: spawn the ranks (``tools/chip_train_ranks.py``, which
    fail the phase by raising); check every layout's training (loss and
    norm bits on every rank, replicas bit-equal, bytes by axis and the
    parameters gathered against their reckonings), the one-process
    cross-checks, the checkpoint restored onto 2 ranks and onto one
    process, and the decodes' tokens against the one-process decode's
    on the same mesh.  Returns the launches of the training steps and
    the decodes, summed over ranks."""
    import shutil
    import torch
    from repro_torch.ckpt.checkpoint import restore
    from repro_torch.configs.base import get_config
    from repro_torch.launch.ranks import spawn_ranks
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    sys.path.insert(0, str(ROOT / "tools"))
    import chip_train_ranks as CT
    ckpt = ROOT / "build" / "ranks_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    # on the CPU (a check of this code, not of the card): smoke configs
    smoke = dev.type == "cpu"
    conf = dict(arch=TR_ARCH, batch=TRAIN_B, seq=TRAIN_SEQ, steps=TR_STEPS,
                xcheck_layers=TR_XCHECK_LAYERS, ckpt=str(ckpt),
                layouts=TR_LAYOUTS, trace=bool(TR_FAKE),
                decode={(a, lay): _ranks_decode_argv(a, lay[1])[1:]
                        for a in TR_DECODE_ARCHS for lay in TR_LAYOUTS},
                decode_wide={a: (_wide_decode_argv(a, smoke)[1:], ch)
                             for a, ch in TR_WIDE.items()},
                smoke=smoke, device=dev.type)
    _free_card()
    try:
        t0 = time.perf_counter()
        outs = spawn_ranks(CT.run, RANKS, args=(conf,), timeout=TR_TIMEOUT)
        secs = time.perf_counter() - t0
        launches = {name: 0 for name in _build.LAUNCHES}
        for o in outs:
            for lay in TR_LAYOUTS:
                for counts in o["train"][lay]["launches"]:
                    for name, n in counts.items():
                        launches[name] += n
            for d in list(o["decode"].values()) + list(
                    o["decode_f32"].values()):
                for name, n in d["launches"].items():
                    launches[name] += n
        cfg = get_config(TR_ARCH)
        if smoke:
            from repro_torch.configs.base import smoke_config
            cfg = smoke_config(cfg)
        # (a) training and (b) the f32 cross-checks, at each layout
        for lay in TR_LAYOUTS:
            _check_train_layout(lay, [o["train"][lay] for o in outs], cfg,
                                card)
            _check_xcheck_layout(lay, outs)
        _check_tp_trace(outs, dev)
        t0 = time.perf_counter()
        saved = outs[0]["xcheck"][(2, 2)]["saved"]
        back2 = spawn_ranks(CT.restore_onto, 2, args=(conf,),
                            timeout=TR_TIMEOUT)
        for b in back2:
            _same_digests("checkpoint onto 2 ranks", b, saved)
        _free_card()
        xcfg = dataclasses.replace(cfg, n_layers=TR_XCHECK_LAYERS,
                                   param_dtype="float32",
                                   compute_dtype="float32")
        lm = M.init_params(torch.Generator(dev).manual_seed(1), xcfg,
                           max_seq=TRAIN_SEQ, device=dev)
        lm, opt = restore(str(ckpt), 1, (lm, adamw_init(lm, AdamWConfig())),
                          device=dev)
        one = {"params": {n: CT.digest(p) for n, p in
                          lm.named_parameters()},
               "m": {n: CT.digest(t) for n, t in opt.m.items()},
               "v": {n: CT.digest(t) for n, t in opt.v.items()}}
        _same_digests("checkpoint onto one process", one, saved)
        del lm, opt
        _free_card()
        print(f"[train ranks] the 4 ranks' (2, 2) checkpoint restored onto "
              f"2 ranks and onto one process bit for bit "
              f"({len(one['params'])} parameters, both moments)")
        took = {"checkpoint": time.perf_counter() - t0}
        # (c) the decodes: f32 tokens == one process's; bf16 agreement
        for arch in TR_DECODE_ARCHS:
            t0 = time.perf_counter()
            argv = _ranks_decode_argv(arch)[1:]
            got = [o["decode_f32"][(arch, (2, 2))] for o in outs]
            blocks = _decode_blocks(dev, argv, 2, "float32")
            _free_card()
            _require(all((g["tokens"] == blocks).all() for g in got),
                     f"decode {arch} over ranks in f32: tokens "
                     f"{got[0]['tokens']} != the one-process decode's of "
                     f"each data block {blocks}")
            print(f"[decode ranks] {arch} in f32 (TF32 off), products "
                  f"split over the model ranks: the ranks' tokens == one "
                  f"process's, data block by data block (first difference "
                  f"at step {_first_diff(got[0]['tokens'], blocks)})")
            _check_decode_layout(f"{arch} (2, 2) f32", got)
            low = [o["decode"][arch] for o in outs]
            _check_decode_layout(f"{arch} (2, 2)", low)
            _require(all((g["tokens"] == low[0]["tokens"]).all()
                         for g in low),
                     f"decode {arch} over ranks: the ranks' tokens differ")
            _check_decode_logits(arch, [g["logits"] for g in low],
                                 CT.decode_logits(argv, dev, blocks=2))
            _free_card()
            one = _decode_blocks(dev, argv, 2)
            _free_card()
            print(f"[decode ranks] {arch} in the config's dtype over the "
                  f"ranks agrees with one process's data blocks on "
                  f"{int((low[0]['tokens'] == one).sum())} of {one.size} "
                  f"tokens (first differing step: "
                  f"{_first_diff(low[0]['tokens'], one)})")
            dcfg = get_config(arch)
            if smoke:
                from repro_torch.configs.base import smoke_config
                dcfg = smoke_config(dcfg)
            for what, runs in (("", low), (" f32", got)):
                if not smoke:            # the CPU path launches nothing
                    _check_decode_run(
                        f"decode{what} {arch} over ranks", dcfg,
                        torch.from_numpy(runs[0]["tokens"]),
                        {k: sum(g["launches"][k] for g in runs)
                         for k in ("topk", "merge")})
                t_dec = runs[0]["t_decode"]
                print(f"[decode ranks]{what} {arch} (2, 2) over {RANKS} "
                      f"ranks, {DEC_P} vocabulary peers: prefill "
                      f"{runs[0]['t_prefill']:.3f} s, {DEC_GEN - 1} steps "
                      f"in {t_dec:.3f} s "
                      f"({(DEC_GEN - 1) * DEC_B / t_dec:.3f} tok/s); bytes "
                      f"delivered across ranks by axis "
                      f"{[g['sent_by_axis'] for g in runs]}; launches by "
                      f"rank {[g['launches'] for g in runs]}; {card}")
            took[f"decode {arch} (2, 2)"] = time.perf_counter() - t0
        for arch in TR_DECODE_ARCHS:
            t0 = time.perf_counter()
            _check_whole_batch_decode(
                dev, f"{arch} (1, 4)", _ranks_decode_argv(arch, 4)[1:],
                [o["decode_f32"][(arch, (1, 4))] for o in outs], None, card)
            took[f"decode {arch} (1, 4)"] = time.perf_counter() - t0
        for arch, changes in TR_WIDE.items():
            t0 = time.perf_counter()
            _check_whole_batch_decode(
                dev, f"{arch} {changes} (1, 4)",
                _wide_decode_argv(arch, smoke)[1:],
                [o["decode_f32"][(arch, "wide")] for o in outs], changes,
                card)
            took[f"decode {arch} wide"] = time.perf_counter() - t0
        for r, o in enumerate(outs):
            print(f"[phase 16] rank {r}: {o['seconds']:.3f} s, "
                  f"max_memory_allocated {o.get('max_memory_allocated')} B;"
                  " seconds by part " + json.dumps(
                      {k: round(v, 3)
                       for k, v in o["seconds_by_part"].items()}))
        print("[phase 16] this process's checks, seconds by part "
              + json.dumps({k: round(v, 3) for k, v in took.items()}))
        print(f"[phase 16] {RANKS} gloo ranks on {card}: {secs:.3f} s")
        _left_behind(dev)
        return launches
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def _check_decode_layout(what, runs):
    """Each rank's decode state after ``serve decode`` over the ranks:
    the caches cut over the model ranks == those the rule cuts, their
    bytes == ``decode_state_layout``'s block; one more decode step's
    bytes == ``model_axis_events``' reckoning on the model axis, nothing
    on the data axis.  Prints each rank's figures."""
    for r, g in enumerate(runs):
        lay, step = g["layout"], g["step"]
        print(f"[decode ranks] {what} rank {r}: caches cut {lay['split']} "
              f"(the rule's {lay['want_split']}), {lay['bytes']} B (the "
              f"layout's block {lay['layout_bytes']} B); a "
              f"decode step delivered {step['sent']} B (model axis "
              f"reckoned {step['reckoned_model']} B)")
        _require(lay["bytes"] == lay["layout_bytes"]
                 and lay["split"] == lay["want_split"],
                 f"decode {what}: rank {r}'s caches {lay}")
        _require(step["sent"] == {"data": 0,
                                  "model": step["reckoned_model"]},
                 f"decode {what}: rank {r}'s step delivered "
                 f"{step['sent']}, reckoned {step['reckoned_model']}")


def _check_whole_batch_decode(dev, what, argv, runs, changes, card):
    """An f32 decode over (1, 4) (TF32 off) against one process's decode
    of the whole batch on the same mesh shape (:func:`_decode_blocks`),
    and its layout (:func:`_check_decode_layout`).  Every rank's tokens
    are the same; a dense model's equal one process's.  A MoE model's
    logits and routers are gated instead (:func:`_check_moe_decode`),
    and its tokens printed: its routers' top-k turns a difference in
    the last bit of a router probability into another expert where two
    experts nearly tie, and its capacity then moves the batch-mates'
    rows too (reference fault 8)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import _decode_args
    one = _decode_blocks(dev, argv, 1, "float32", changes)
    _free_card()
    _require(all((g["tokens"] == runs[0]["tokens"]).all() for g in runs),
             f"decode {what} over ranks in f32: the ranks' tokens differ")
    agree = (f"{int((runs[0]['tokens'] == one).sum())} of {one.size} tokens "
             f"equal, first differing step "
             f"{_first_diff(runs[0]['tokens'], one)}")
    if get_config(_decode_args(argv).arch).moe is None:
        _require((runs[0]["tokens"] == one).all(),
                 f"decode {what} over ranks in f32: tokens "
                 f"{runs[0]['tokens']} != one process's {one}")
    else:
        _check_moe_decode(dev, what, argv, [g["logits"] for g in runs])
    _check_decode_layout(f"{what} f32", runs)
    g = runs[0]
    print(f"[decode ranks] {what} in f32 (TF32 off), each cache's "
          f"sequence cut over the model ranks, against one process's "
          f"whole-batch decode: {agree}; prefill "
          f"{g['t_prefill']:.3f} s, {DEC_GEN - 1} steps in "
          f"{g['t_decode']:.3f} s; bytes delivered across ranks by axis "
          f"{[r['sent_by_axis'] for r in runs]}; launches by rank "
          f"{[r['launches'] for r in runs]}; {card}")


def _left_behind(dev):
    """What phase 16 leaves on the card: no rank process may outlive
    ``spawn_ranks``; on the card, prints this process's allocator
    state and the card's compute processes as ``nvidia-smi`` lists
    them."""
    import multiprocessing
    import torch
    left = multiprocessing.active_children()
    _require(not left, f"phase 16 left rank processes alive: {left}")
    if dev.type != "cuda":
        return
    _free_card()
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(f"[phase 16] after: no rank process alive; this process "
          f"allocated {torch.cuda.memory_allocated(dev)} B, reserved "
          f"{torch.cuda.memory_reserved(dev)} B; compute processes on "
          f"the card {apps}")


def _profiler_probe(scores, reps=10):
    """One profiler window of ``reps`` select-route calls (local
    execution at k = 512, one ``sel_resident`` launch a call), as phase
    6 takes them, run after phase 16: how many of the ``reps`` kernel
    records the window holds.  Printed, not required: it shows whether
    a window after phase 16 loses records (phase 16 runs after the
    timing windows for that reason; PERF.md section 7)."""
    from repro_torch.kernels.topk import topk_cuda
    x = scores.view(DEV_B * DEV_PEERS, DEV_LOCAL)
    ks = _kernels_of(lambda: topk_cuda(x, 512), reps, reps, tries=1)
    print(f"[phase 16] after: a profiler window of {reps} select-route "
          f"calls held {len(ks)} of {reps} kernel records")


# ---------------------------------------------------------------------------
# phase 6: times at main-path shapes
# ---------------------------------------------------------------------------

def _merge_pairs(levels, rr=None):
    """Each merge of one sweep as (list pairs, masked): the fold's rounds
    (masked), then the parents' merge with their own lists (unmasked),
    per level; with ``rr``, the reroute-augmented fold where a level has
    one."""
    pairs = []
    for d, lv in enumerate(levels):
        if "cnode" not in lv:
            continue
        rounds = (rr[d]["rounds"] if rr is not None and rr[d] is not None
                  else lv["rounds"])
        pairs += [(mi_a.shape[0], True) for mi_a, _, _ in rounds]
        pairs.append((lv["par_sel"].shape[0], False))
    return pairs


def _merge_calls(pairs, dev, gen, dt=None, rows=E_MAIN):
    """Random descending K=32 list pairs at the sizes ``pairs``, ``rows``
    entries, f64 (or ``dt``, drawn in f32 and rounded)."""
    import torch
    from repro_torch.engine.sim_torch import _next_pow2
    K = _next_pow2(20)
    merge = []

    def lists(P):
        if dt is None:
            return _sorted_lists((rows, P), K, torch.float64, gen, dev,
                                 False)
        v, i = _sorted_lists((rows, P), K, torch.float32, gen, dev, False)
        return v.to(dt), i

    for P, masked in pairs:
        va, ia = lists(P)
        vb, ib = lists(P)
        ma = mb = None
        if masked:
            ma = torch.rand((rows, P), generator=gen, device=dev) < 0.9
            mb = torch.rand((rows, P), generator=gen, device=dev) < 0.9
        merge.append((va, ia, vb, ib, ma, mb))
    return merge


def _level_calls(levels, dev, gen, dt=None):
    """One sweep's worth of inputs per sweep kernel, at E=32, f64 (or
    ``dt``, drawn in f32 and rounded)."""
    import torch
    f64 = torch.float64

    def rnd(*shape):
        if dt is None:
            return torch.rand(shape, generator=gen, device=dev, dtype=f64)
        return torch.rand(shape, generator=gen, device=dev,
                          dtype=torch.float32).to(dt)

    arr, wait, wait_churn = [], [], []
    for d, lv in enumerate(levels):
        L = lv["vv"].shape[0]
        if d > 0:
            Lp = levels[d - 1]["vv"].shape[0]
            arr.append((rnd(E_MAIN, Lp), rnd(E_MAIN, L), lv["par_pos"]))
        wait.append((rnd(E_MAIN, L), rnd(E_MAIN, L), rnd(E_MAIN, L)))
        # death times around the send times: about a third die
        wait_churn.append(wait[-1] + (1.5 * rnd(E_MAIN, L),))
    return arr, wait, wait_churn


def _nbytes(t):
    return t.numel() * t.element_size()


def _arrivals_bytes(tq, dn, pp, whole=False):
    """Bytes one arrivals launch must move: the distinct parents each
    row reads (all of tq_prev when ``whole``, the formula before this
    count), dn read, out written and par_pos."""
    parents = (_nbytes(tq) if whole else int(pp.unique().numel())
               * tq.shape[0] * tq.element_size())
    return parents + 2 * _nbytes(dn) + _nbytes(pp)


def _merge_bytes(merge):
    """Bytes of the merges ``merge``: both lists (+ masks) read once, one
    list written."""
    nb = _nbytes
    return sum(nb(va) + nb(ia) + nb(vb) + nb(ib) + nb(va) + nb(ia)
               + (0 if ma is None else nb(ma) + nb(mb))
               for va, ia, vb, ib, ma, mb in merge)


def _check_merges_at(merge, errs, note):
    """The merge kernel bit-equal to its plain version on the list pairs
    ``merge`` (into outputs filled with NaN)."""
    from repro_torch.kernels.merge import merge_cuda, merge_ref
    for va, ia, vb, ib, ma, mb in merge:
        v1, i1 = merge_cuda(va, ia, vb, ib, valid_a=ma, valid_b=mb,
                            out=_nan_out(va.shape, va.dtype, va.device))
        v2, i2 = merge_ref(va, ia, vb, ib, valid_a=ma, valid_b=mb)
        errs["merge"] = max(errs["merge"], _max_abs_err(v1, v2))
        _require(_same(v1, v2) and _same(i1, i2),
                 f"merge at the shapes of {note}: kernel != plain")
    return len(merge)


def _merge_row(name, merge, errs, note):
    """The merge's timing entry at the list pairs ``merge``, held to its
    plain version there first."""
    import torch
    from repro_torch.kernels.merge import merge_cuda, merge_ref
    _check_merges_at(merge, errs, note)
    cats = [torch.cat([va, vb], dim=-1) for va, _, vb, _, _, _ in merge]
    m_bytes = _merge_bytes(merge)
    # one binary search of log2(K) + 1 compares per input element
    m_ops = sum(2 * va.numel() * (math.log2(va.shape[-1]) + 1)
                for va, *_ in merge)
    return (name, "src/repro_torch/kernels/csrc/merge.cu",
            "src/repro/kernels/merge/merge.py:140", len(merge),
            m_bytes, m_ops,
            lambda: [merge_cuda(va, ia, vb, ib, valid_a=ma, valid_b=mb)
                     for va, ia, vb, ib, ma, mb in merge],
            lambda: [merge_ref(va, ia, vb, ib, valid_a=ma, valid_b=mb)
                     for va, ia, vb, ib, ma, mb in merge],
            lambda: [torch.sort(c, dim=-1, descending=True, stable=True)
                     for c in cats], "merge", note,
            lambda: [torch.topk(c, va.shape[-1], dim=-1)
                     for c, (va, *_) in zip(cats, merge)])


def _times(levels, rr, dev, gen, errs, launches):
    from repro_torch.kernels.sweep import (arrivals_cuda, arrivals_ref,
                                           wait_cuda, wait_ref)
    arr, wait, wait_churn = _level_calls(levels, dev, gen)
    static_note = f"one fd-dynamic sweep of origin 0, E={E_MAIN}"
    churn_note = (f"one fd-dynamic sweep of origin 0 at lifetime "
                  f"{CHURN_HEAVY_S:g} s, E={E_MAIN}")
    pairs, rr_pairs = _merge_pairs(levels), _merge_pairs(levels, rr)
    print(f"[times] merges a sweep: {len(pairs)} static, {len(rr_pairs)} "
          f"with the reroute fold; list pairs "
          f"{sum(P for P, _ in pairs)} / {sum(P for P, _ in rr_pairs)}")
    out = [_merge_row("merge", _merge_calls(pairs, dev, gen), errs,
                      static_note)]
    if abs(len(rr_pairs) - len(pairs)) > len(pairs) / 4:
        out.append(_merge_row("merge (reroute fold)",
                              _merge_calls(rr_pairs, dev, gen), errs,
                              churn_note))
    nb = _nbytes
    a_bytes = sum(_arrivals_bytes(*c) for c in arr)
    out.append(("arrivals", "src/repro_torch/kernels/csrc/sweep.cu",
                "src/repro/kernels/sweep/sweep.py:53", len(arr), a_bytes,
                sum(dn.numel() for _, dn, _ in arr),
                lambda: [arrivals_cuda(*c) for c in arr],
                lambda: [arrivals_ref(*c) for c in arr], None, "arrivals",
                static_note, None))
    w_bytes = sum(4 * nb(o) for o, _, _ in wait)
    out.append(("wait", "src/repro_torch/kernels/csrc/sweep.cu",
                "src/repro/kernels/sweep/sweep.py:98", len(wait), w_bytes,
                sum(4 * o.numel() for o, _, _ in wait),
                lambda: [wait_cuda(*c) for c in wait],
                lambda: [wait_ref(*c) for c in wait], None, "wait",
                static_note, None))
    for c in wait_churn:
        s1, snd1 = wait_cuda(*c)
        s2, snd2 = wait_ref(*c)
        errs["wait_churn"] = max(errs["wait_churn"], _max_abs_err(s1, s2),
                                 _max_abs_err(snd1, snd2))
        _require(_same(s1, s2) and _same(snd1, snd2),
                 "wait (churn variant) at the churn sweep's shapes: "
                 "kernel != plain")
    # four (E, L) inputs read, s and send written
    out.append(("wait_churn", "src/repro_torch/kernels/csrc/sweep.cu",
                "src/repro/kernels/sweep/sweep.py:102", len(wait_churn),
                sum(6 * nb(c[0]) for c in wait_churn),
                sum(6 * c[0].numel() for c in wait_churn),
                lambda: [wait_cuda(*c) for c in wait_churn],
                lambda: [wait_ref(*c) for c in wait_churn], None,
                "wait_churn", churn_note, None))
    rows = []
    for (name, source, replaces, calls, nbytes, nops, kern, plain,
         lib, counter, note, lib2) in out:
        # the device time of this kernel's own launches in one sweep
        dev_ms = _device_ms(kern, match=(f"{counter}_kernel",))
        # plain, kernel, kernel, plain: take the lower of each pair
        p1 = _cuda_ms(plain)
        k1 = _cuda_ms(kern)
        k2 = _cuda_ms(kern)
        p2 = _cuda_ms(plain)
        t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
        t_ops = nops / OPS_PER_S * 1e3
        by_path = {path: n[counter] for path, n in launches.items()}
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": errs[counter], "ms": min(k1, k2),
            "plain_ms": min(p1, p2), "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if lib is None else _cuda_ms(lib),
            "device_ms": dev_ms,
            "device_ms_per_launch": None if dev_ms is None
            else dev_ms / calls,
            "library_device_ms": None if lib is None else _device_ms(lib),
            "calls_per_sweep": calls, "bytes_per_sweep": nbytes,
            "shape_note": note})
        if lib2 is not None:
            # torch.topk of the concatenation: a yardstick only (its tie
            # order is not the merge's)
            rows[-1]["library_topk_ms"] = _cuda_ms(lib2)
            rows[-1]["library_topk_device_ms"] = _device_ms(lib2)
    # the arrivals level by level: the small levels are bound by their
    # launches, the large ones by their bytes
    each = _device_ms_each(lambda: [arrivals_cuda(*c) for c in arr],
                           len(arr), "arrivals_kernel")
    row = next(r for r in rows if r["name"] == "arrivals")
    row["levels"] = [
        {"L": dn.shape[1], "L_prev": tq.shape[1],
         "distinct_parents": int(pp.unique().numel()),
         "device_ms": None if each is None else each[i],
         "bound_ms": _arrivals_bytes(tq, dn, pp) / MEM_BYTES_PER_S * 1e3,
         "bound_ms_whole_parent_level":
         _arrivals_bytes(tq, dn, pp, whole=True) / MEM_BYTES_PER_S * 1e3}
        for i, (tq, dn, pp) in enumerate(arr)]
    row["bound_ms_whole_parent_level"] = sum(
        lv["bound_ms_whole_parent_level"] for lv in row["levels"])
    print("[times] arrivals by level " + json.dumps(row["levels"]))
    # the waits level by level: four of the seven levels are small
    for name, calls, arrays in (("wait", wait, 4),
                                ("wait_churn", wait_churn, 6)):
        each = _device_ms_each(lambda: [wait_cuda(*c) for c in calls],
                               len(calls), f"{name}_kernel")
        row = next(r for r in rows if r["name"] == name)
        row["levels"] = [
            {"L": c[0].shape[1], "elements": c[0].numel(),
             "device_ms": None if each is None else each[i],
             "bound_ms": arrays * nb(c[0]) / MEM_BYTES_PER_S * 1e3}
            for i, c in enumerate(calls)]
        print(f"[times] {name} by level " + json.dumps(row["levels"]))
    return rows


def _dtype_times(levels, dev, gen, errs):
    """The sim kernels at one phase-3 sweep's shapes in f32 and bf16, as
    the reduced-precision sweep runs them: each held bit-equal to its
    plain version there, then events ``ms`` (lower of two medians),
    ``device_ms`` (one profiler window, per sweep) and the bytes bound at
    that element size."""
    import torch
    from repro_torch.kernels.merge import merge_cuda, merge_ref
    from repro_torch.kernels.sweep import (arrivals_cuda, arrivals_ref,
                                           wait_cuda, wait_ref)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).split(".")[-1]
        merge = _merge_calls(_merge_pairs(levels), dev, gen, dt)
        arr, wait, wait_churn = _level_calls(levels, dev, gen, dt)
        for va, ia, vb, ib, ma, mb in merge:
            v1, i1 = merge_cuda(va, ia, vb, ib, valid_a=ma, valid_b=mb,
                                out=_nan_out(va.shape, dt, dev))
            v2, i2 = merge_ref(va, ia, vb, ib, valid_a=ma, valid_b=mb)
            errs["merge"] = max(errs["merge"], _max_abs_err(v1, v2))
            _require(_same(v1, v2) and _same(i1, i2),
                     f"merge {tag} at the phase-3 shapes: kernel != plain")
        for c in arr:
            got, ref = arrivals_cuda(*c), arrivals_ref(*c)
            errs["arrivals"] = max(errs["arrivals"], _max_abs_err(got, ref))
            _require(_same(got, ref), f"arrivals {tag} at the phase-3 "
                     "shapes: kernel != plain")
        for c in wait:
            got, ref = wait_cuda(*c), wait_ref(*c)
            errs["wait"] = max(errs["wait"], _max_abs_err(got, ref))
            _require(_same(got, ref), f"wait {tag} at the phase-3 shapes: "
                     "kernel != plain")
        for c in wait_churn:
            (s1, n1), (s2, n2) = wait_cuda(*c), wait_ref(*c)
            errs["wait_churn"] = max(errs["wait_churn"], _max_abs_err(s1, s2),
                                     _max_abs_err(n1, n2))
            _require(_same(s1, s2) and _same(n1, n2), f"wait (churn variant)"
                     f" {tag} at the phase-3 shapes: kernel != plain")
        nb = _nbytes
        calls = {
            "merge": (lambda: [merge_cuda(va, ia, vb, ib, valid_a=ma,
                                          valid_b=mb)
                               for va, ia, vb, ib, ma, mb in merge],
                      _merge_bytes(merge)),
            "arrivals": (lambda: [arrivals_cuda(*c) for c in arr],
                         sum(_arrivals_bytes(*c) for c in arr)),
            "wait": (lambda: [wait_cuda(*c) for c in wait],
                     sum(4 * nb(o) for o, _, _ in wait)),
            "wait_churn": (lambda: [wait_cuda(*c) for c in wait_churn],
                           sum(6 * nb(c[0]) for c in wait_churn)),
        }
        for name, (kern, nbytes) in calls.items():
            dev_ms = _device_ms(kern, match=(f"{name}_kernel",))
            ms = min(_cuda_ms(kern), _cuda_ms(kern))
            bound = nbytes / MEM_BYTES_PER_S * 1e3
            out.setdefault(name, {})[tag] = {
                "ms": ms, "device_ms": dev_ms, "bound_ms": bound,
                "bound_by": "bytes", "bytes_per_sweep": nbytes}
            print(f"[times] {name} {tag}: " + json.dumps(out[name][tag]))
    return out


def _sum_or_none(xs):
    xs = list(xs)
    return None if any(x is None for x in xs) else sum(xs)


def _topk_shape(what, x, errs, k=DEV_K):
    """The tile-route top-k at ``k`` (20 by default) on ``x``: held to
    its plain version, then timed beside it and ``torch.topk`` (events,
    and device ms from a profiler window retaken until it holds every
    launch), with its bound (each score read once, each (value, index)
    written once)."""
    import torch
    from repro_torch.kernels.topk import topk_cuda, topk_ref
    from repro_torch.kernels.topk.topk import plan as topk_plan
    v1, i1 = topk_cuda(x, k)
    v2, i2 = topk_ref(x, k)
    errs["topk"] = max(errs["topk"], _max_abs_err(v1, v2))
    _require(_same(v1, v2) and _same(i1, i2),
             f"topk at the {what} shape: kernel != plain version")
    # plain, kernel, kernel, plain: take the lower of each pair
    p1 = _cuda_ms(lambda: topk_ref(x, k))
    k1 = _cuda_ms(lambda: topk_cuda(x, k))
    k2 = _cuda_ms(lambda: topk_cuda(x, k))
    p2 = _cuda_ms(lambda: topk_ref(x, k))
    lib = _cuda_ms(lambda: torch.topk(x, k, dim=-1))
    # one launch a call for a one-tile row, else the final pass too; a
    # window that misses one is taken again
    n_launch = 1 if topk_plan(x.shape[-1], k).tiles == 1 else 2
    each = _device_ms_each(lambda: topk_cuda(x, k), n_launch,
                           ("topk_tiles", "topk_final"))
    rows = x.numel() // x.shape[-1]
    nbytes = x.numel() * x.element_size() + rows * k * 8
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = x.numel() / OPS32_PER_S * 1e3    # one compare a score
    row = {"what": what, "shape": list(x.shape), "k": k,
           "launches_per_call": n_launch,
           "ms": min(k1, k2), "plain_ms": min(p1, p2),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": lib,
           "device_ms": None if each is None else sum(each),
           "library_device_ms": _device_ms(
               lambda: torch.topk(x, k, dim=-1)), "bytes": nbytes}
    print(f"[times] topk {what} {tuple(x.shape)} f32 k={k}: "
          + json.dumps(row))
    return row


def _topk_row(scores, dec_scores, errs, launches, var_scores, router,
              train_router):
    """The top-k at the device path's three shapes: local execution of
    the 32 queries on 64 peers, CN over the full rows, CN* over the
    gathered k-lists; each held to its plain version, then timed.  The
    decode's two shapes (its 16 peers' shards, and the whole row at one
    peer), qwen2-0.5b's and each other arch's (``var_scores``), are
    timed the same way under ``decode_shapes``, and each MoE arch's
    router at its decode (4, E) and prefill (128, E) shapes
    (``router``: layer 0's probabilities and k) and granite's in
    training at (1,024, 32) (``train_router``, phase 14's) under
    ``router_shapes``, outside the row's sums."""
    from repro_torch.kernels.topk import topk_cuda
    lists = topk_cuda(scores.view(DEV_B, DEV_PEERS, DEV_LOCAL), DEV_K)[0]
    shapes = (("local execution", scores.view(DEV_B * DEV_PEERS, DEV_LOCAL)),
              ("CN", scores),
              ("CN*", lists.reshape(DEV_B, DEV_PEERS * DEV_K)))
    per = [_topk_shape(what, x, errs) for what, x in shapes]
    decode = [_topk_shape(f"{arch} decode, {part}", x, errs)
              for arch, sc in ((DEC_ARCH, dec_scores), *var_scores.items())
              for part, x in (("16 peers' shards",
                               sc.reshape(sc.shape[0] * DEC_P, -1)),
                              ("one peer", sc))]
    routers = [_topk_shape(f"{arch} router, {part}", r[part], errs, r["k"])
               for arch, r in router.items()
               for part in ("decode", "prefill")]
    probs, k = train_router
    routers.append(_topk_shape(f"{TRAIN_ARCH} router, train", probs, errs,
                               k))
    by_path = {path: n["topk"] for path, n in launches.items()}
    t_bytes = sum(r["bytes"] for r in per) / MEM_BYTES_PER_S * 1e3
    t_ops = sum(math.prod(r["shape"]) for r in per) / OPS32_PER_S * 1e3
    dev_ms = _sum_or_none(r["device_ms"] for r in per)
    return {
        "name": "topk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/topk.cu",
        "replaces": "src/repro/kernels/topk/topk.py:120",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": errs["topk"],
        "ms": sum(r["ms"] for r in per),
        "plain_ms": sum(r["plain_ms"] for r in per),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": sum(r["library_ms"] for r in per),
        "device_ms": dev_ms,
        "device_ms_per_launch": None if dev_ms is None else dev_ms / len(per),
        "library_device_ms": _sum_or_none(r["library_device_ms"]
                                          for r in per),
        "shapes": per, "decode_shapes": decode, "router_shapes": routers,
        "shape_note": (f"one call at each device-path shape: local "
                       f"execution of {DEV_B} queries on {DEV_PEERS} "
                       f"peers, CN, CN*")}


def tagged(tag, fn):
    """``fn`` launched inside the profiler range ``tag:<tag>``, which
    :func:`kernels_by_tag` joins its kernels to (shared with tools/)."""
    import torch

    def call(*a, **kw):
        with torch.profiler.record_function(f"tag:{tag}"):
            return fn(*a, **kw)
    return call


def _kernel_name(name):
    """A kernel's function name, without namespace, template arguments
    and parameters."""
    import re
    name = name.replace("(anonymous namespace)::", "")
    m = re.search(r"([A-Za-z_]\w*)(?:<.*?>)?\(", name)
    return m.group(1) if m else name


def _trace_kernels(prof):
    """(tag, kernel name, start us, duration us) of every kernel in a
    profiler window, joined to the :func:`tagged` range that holds its
    launch through the launch's correlation id in the exported trace
    (tag None outside every range), and the tagged ranges (start, end,
    tag)."""
    import bisect
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(f"{d}/trace.json")
        events = json.loads(Path(d, "trace.json").read_text())["traceEvents"]
    tags = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"][4:])
                  for e in events if e.get("cat") == "user_annotation"
                  and e.get("name", "").startswith("tag:"))
    starts = [t[0] for t in tags]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "Launch" in e.get("name", "")
                 and "correlation" in e.get("args", {})}
    out = []
    for e in events:
        if e.get("cat") != "kernel":
            continue
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        i = -1 if t is None else bisect.bisect_right(starts, t) - 1
        tag = tags[i][2] if i >= 0 and t <= tags[i][1] else None
        out.append((tag, _kernel_name(e["name"]), e["ts"], e["dur"]))
    return out, tags


def kernels_by_tag(calls, reps=10):
    """The kernels that the functions ``calls`` launch inside
    :func:`tagged` ranges: one ``torch.profiler`` window runs each in
    turn, ``reps`` times, and every kernel is joined to the range that
    holds its launch (:func:`_trace_kernels`), so a kernel the trace
    lacks drops out of its own range only and a kernel of no range is
    left out.  Returns {tag: {kernel name: [us, ...]}} (shared with
    tools/)."""
    for fn in calls:
        fn()
    prof = _profiled(lambda: [fn() for _ in range(reps) for fn in calls])
    per = {}
    for tag, name, _, dur in _trace_kernels(prof)[0]:
        if tag is not None:
            per.setdefault(tag, {}).setdefault(name, []).append(dur)
    return per


def _kernels_of(fn, n, reps=10, tries=3):
    """(kernel name, device us) of each kernel, in launch order, that
    ``reps`` calls of ``fn`` launch, from a profiler window that holds
    nothing else.  Read from the kernel records alone, not joined to
    their launches (late in a long run on the H100 the trace lacks some
    launch records).  A window without ``n`` kernels is taken again, up
    to ``tries`` windows; the last one is returned."""
    fn()
    for attempt in range(1, tries + 1):
        ks = [(name, dur) for _, name, _, dur in sorted(
            _trace_kernels(_profiled(lambda: [fn() for _ in range(reps)]))[0],
            key=lambda k: k[2]) if name != _MARKER]
        if len(ks) == n:
            break
        print(f"[times] profiler window {attempt} of {tries} saw {len(ks)} "
              f"kernels of {n}")
    return ks


# the select routes' shapes: local execution of the device path's
# queries at two k above the tile route, and CN's gather at the default
# k_frac = 1e-3 of optim/compress.py (1,280 of 1,280,000)
_SELECT_SHAPES = (("local execution", 512), ("local execution", 4096),
                  ("CN", 1_280))
# the kernels of each select route, in launch order
_SELECT_KERNELS = {"resident": ("sel_resident",),
                   "long": ("sel_long_count", "sel_long_tiles",
                            "sel_long_final")}


def _total_order_keys(v):
    """The 32-bit total-order keys of f32 values (the kernels' key_of),
    as the bits of an int32 tensor."""
    import torch
    b = v.contiguous().view(torch.int32).to(torch.int64)
    b = b ^ ((b >> 31) & 0x7FFFFFFF)
    k = (b ^ 0x80000000) & 0xFFFFFFFF
    return torch.where(k >= 2 ** 31, k - 2 ** 32, k).to(torch.int32)


def _sort_ms(x, k, reps=10):
    """Device ms of the select routes' sort alone
    (``repro_topk_select_sort``) on the k winners of each row of x, in
    row order, held to ``topk_ref``; None where they do not fit one
    block."""
    import ctypes
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.topk import topk_ref
    fn = _build.function("topk_select", "repro_topk_select_sort",
                         [ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_void_p])
    v, i = topk_ref(x, k)
    i, perm = i.sort(dim=-1)
    keys = _total_order_keys(v.gather(-1, perm)).contiguous()
    i = i.contiguous()
    vo = torch.full_like(v, float("nan"))
    io = torch.empty_like(i)

    def call():
        return fn(keys.data_ptr(), i.data_ptr(), x.shape[0], k,
                  vo.data_ptr(), io.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
    if call() != 0:
        return None
    torch.cuda.synchronize()
    _require(_same(vo, v) and _same(io, topk_ref(x, k)[1]),
             f"topk select sort at k={k}: != topk_ref")
    ks = _kernels_of(call, reps, reps)
    _require(len(ks) == reps,
             f"topk select sort: {len(ks)} kernels in {reps} calls")
    return sum(us for _, us in ks) / reps / 1e3


def _topk_select_row(scores, errs, launches, leaf):
    """The top-k's select routes (k > 256) at ``_SELECT_SHAPES`` and at
    phase 15's largest gradient leaf (``leaf``: its name, shape and k;
    the magnitudes rank 0 selects in round 1): each held to its plain
    version, then timed beside ``torch.topk``; each shape's route, its
    launches a call (required to be the route's kernels, one launch
    each), their device ms, and the sort's."""
    import torch
    from repro_torch.kernels.topk import topk_cuda, topk_ref
    from repro_torch.kernels.topk.topk import plan
    leaf_name, leaf_shape, leaf_k = leaf
    leaf_what = f"gradient leaf {leaf_name}"
    xs = {"local execution": scores.view(DEV_B * DEV_PEERS, DEV_LOCAL),
          "CN": scores, leaf_what: _rank_leaf(scores.device, leaf_shape)}
    per = []
    for what, k in _SELECT_SHAPES + ((leaf_what, leaf_k),):
        x = xs[what]
        route = plan(x.shape[-1], k).route
        v1, i1 = topk_cuda(x, k)
        v2, i2 = topk_ref(x, k)
        errs["topk_select"] = max(errs["topk_select"], _max_abs_err(v1, v2))
        _require(_same(v1, v2) and _same(i1, i2),
                 f"topk select at the {what} shape, k={k}: kernel != plain "
                 "version")
        p1 = _cuda_ms(lambda: topk_ref(x, k))
        k1 = _cuda_ms(lambda: topk_cuda(x, k))
        k2 = _cuda_ms(lambda: topk_cuda(x, k))
        p2 = _cuda_ms(lambda: topk_ref(x, k))
        lib = _cuda_ms(lambda: torch.topk(x, k, dim=-1))
        reps = 10
        want = _SELECT_KERNELS[route]
        ks = _kernels_of(lambda: topk_cuda(x, k), reps * len(want), reps)
        kern = {}
        for name, us in ks:
            kern[name] = kern.get(name, 0.0) + us
        _require(len(ks) == reps * len(want) and set(kern) == set(want),
                 f"topk select at the {what} shape, k={k}: the profiler saw "
                 f"{len(ks)} kernels {sorted(kern)} in {reps} calls, the "
                 f"{route} route launches {want} once each")
        dev_ms = sum(kern.values()) / reps / 1e3
        lib_dev = _device_ms(lambda: torch.topk(x, k, dim=-1), reps=reps)
        # each score read once, each (value, index) written once
        nbytes = x.numel() * x.element_size() + x.shape[0] * k * 8
        t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
        t_ops = x.numel() / OPS32_PER_S * 1e3    # one compare a score
        per.append({"what": what, "shape": list(x.shape), "k": k,
                    "route": route, "launches_per_call": len(want),
                    "ms": min(k1, k2), "plain_ms": min(p1, p2),
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops
                    else "operations",
                    "library_ms": lib, "device_ms": dev_ms,
                    "launch_device_ms": {n: us / reps / 1e3
                                         for n, us in kern.items()},
                    "sort_device_ms": _sort_ms(x, k),
                    "library_device_ms": lib_dev, "bytes": nbytes})
        print(f"[times] topk select {what} {tuple(x.shape)} f32 k={k}: "
              + json.dumps(per[-1]))
    by_path = {path: n["topk_select"] for path, n in launches.items()}
    t_bytes = sum(r["bytes"] for r in per) / MEM_BYTES_PER_S * 1e3
    t_ops = sum(math.prod(r["shape"]) for r in per) / OPS32_PER_S * 1e3
    dev_ms = sum(r["device_ms"] for r in per)
    return {
        "name": "topk_select", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/topk_select.cu",
        "replaces": "src/repro/kernels/topk/topk.py:120",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": errs["topk_select"],
        "ms": sum(r["ms"] for r in per),
        "plain_ms": sum(r["plain_ms"] for r in per),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": sum(r["library_ms"] for r in per),
        "device_ms": dev_ms,
        "device_ms_per_launch": dev_ms / sum(r["launches_per_call"]
                                             for r in per),
        "library_device_ms": _sum_or_none(r["library_device_ms"]
                                          for r in per),
        "shapes": per,
        "shape_note": "one call at each shape: local execution of the "
                      f"device path's {DEV_B} queries on {DEV_PEERS} peers "
                      "at k = 512 and 4096 (resident route), CN at k = "
                      "1,280 (long route), phase 15's largest gradient "
                      f"leaf {leaf_name} {tuple(leaf_shape)} flattened at "
                      f"k = {leaf_k} (long route); a topk_select launch "
                      "of the path counts one call of topk_cuda"}


_T0 = [0.0]


def _elapsed(what):
    """How long the script has run, after ``what``."""
    print(f"[elapsed] {what}: {time.perf_counter() - _T0[0]:.3f} s")


def main() -> int:
    import torch
    _T0[0] = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.engine import SimEngine
    from repro_torch.engine.sim_torch import _device_slices
    from repro_torch.kernels import _build
    from repro_torch.p2psim import SimParams, barabasi_albert

    dev = torch.device("cuda")
    card = _card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    secs = _build.ensure_built()
    print(f"[build] kernels built and loaded in {secs:.3f} s "
          f"({_build.build_dir()})")

    t0 = time.perf_counter()
    top = barabasi_albert(N_PEERS, m=2, seed=7)
    p = SimParams(seed=5)
    engine = SimEngine(top, p)
    sts, _ = engine.plan.origin_statics([0], p.ttl, "st1+2")
    sl = engine.plan.depth_slices(sts[0])
    levels, _, _ = _device_slices(sl, dev)
    print(f"[setup] overlay n={top.n} edges={top.n_edges} ttl="
          f"{sts[0].ttl} levels={[len(lv['vv']) for lv in sl.levels]} in "
          f"{time.perf_counter() - t0:.3f} s")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    errs = {"merge": 0.0, "arrivals": 0.0, "wait": 0.0, "wait_churn": 0.0,
            "topk": 0.0, "topk_select": 0.0}
    n = (_check_merge(gen, dev, errs) + _check_sweep(levels, gen, dev, errs)
         + _check_topk(gen, dev, errs))
    torch.cuda.synchronize()
    print(f"[kernels] {n} comparisons bit-equal to the plain versions "
          f"(f64/f32/bf16/f16); max abs err {errs}")
    _elapsed("phases 1-2")

    serve_launches, _ = _serve(engine, _build)
    _elapsed("phase 3")
    churn_launches, _ = _serve_churn(engine, _build)
    _elapsed("phase 3b")
    _parity(engine, p)
    _elapsed("phase 4")

    dev_launches, scores, _ = _device_path(dev, gen, _build)
    _elapsed("phase 5")
    topo_launches = _topologies(dev, gen, errs, _build)
    _elapsed("phase 7")
    prec_launches, _ = _reduced_precision(engine, dev, gen, errs, _build)
    _elapsed("phase 8")
    overlay_launches = _overlay(dev, gen, errs, _build)
    _elapsed("phase 9")
    dryruns = _p17_dryrun_start()
    try:
        t0 = time.perf_counter()
        cli_launches = _cli(card, _build)
        shard_launches = _shard(engine, p, dev, gen, errs, _build)
        print(f"[phase 10] {time.perf_counter() - t0:.3f} s")
    finally:
        _p17_dryrun(dryruns)
    t0 = time.perf_counter()
    decode_launches, _ = _decode_cli(card, _build)
    dec_scores, _ = _decode_model(dev, card)
    _decode_sampling(dec_scores)
    _decode_xcheck(dev, errs)
    _decode_kernels(dec_scores, errs)
    print(f"[phase 11] {time.perf_counter() - t0:.3f} s")
    _free_card()
    t0 = time.perf_counter()
    var_launches, var_scores = _variants(dev, card, errs, _build)
    print(f"[phase 12] {time.perf_counter() - t0:.3f} s")
    _free_card()
    t0 = time.perf_counter()
    arch_launches, arch_scores, router = _archs(dev, card, errs, _build)
    print(f"[phase 13] {time.perf_counter() - t0:.3f} s")
    _free_card()
    t0 = time.perf_counter()
    train_launches, train_router = _train(dev, card, errs, _build)
    print(f"[phase 14] {time.perf_counter() - t0:.3f} s")
    _free_card()
    rank_launches, rank_leaf = _ranks(dev, card, _build)
    _free_card()
    _elapsed("phase 15")

    launches = {"serve": serve_launches, "serve_churn": churn_launches,
                "device": dev_launches, "topologies": topo_launches,
                **prec_launches, "overlay": overlay_launches,
                "cli": cli_launches, "shard": shard_launches,
                "decode": decode_launches, **var_launches, **arch_launches,
                "train": train_launches, "ranks": rank_launches}
    # phase 3b extended origin 0's slices with the reroute tables
    rr = _device_slices(engine.plan.depth_slices(sts[0]), dev)[2]
    _require(rr is not None, "phase 3b built no reroute tables")
    rows = _times(levels, rr, dev, gen, errs, launches)
    by_dtype = _dtype_times(levels, dev, gen, errs)
    for row in rows:
        if row["name"] in by_dtype:
            row["by_dtype"] = by_dtype[row["name"]]
    rows.append(_topk_row(scores, dec_scores, errs, launches,
                          {**var_scores, **arch_scores}, router,
                          train_router))
    rows.append(_topk_select_row(scores, errs, launches, rank_leaf))
    _elapsed("phase 6")
    _free_card()
    _dryrun_phase(dev, card, _build)
    _elapsed("phase 17")
    _free_card()
    # phase 16 runs after the timing windows: one call with it before
    # them lost kernel records in phase 6's windows, cause not found
    # (PERF.md section 7); the probe after it shows whether a window
    # loses records then
    t0 = time.perf_counter()
    tsr_launches = _train_serve_ranks(dev, card, _build)
    print(f"[phase 16] {time.perf_counter() - t0:.3f} s in all")
    _profiler_probe(scores)
    _elapsed("phase 16")
    for row in rows:
        n = tsr_launches[row["name"]]
        row["launches_by_path"]["train_serve_ranks"] = n
        row["launches"] += n
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:                    # noqa: BLE001 — any phase fault
        traceback.print_exc()
        code = 1
    sys.exit(code)
