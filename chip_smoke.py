#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of SharedDB (the query engine and
the LM server) on one NVIDIA GPU.

    python3 chip_smoke.py

from the repository root, on a machine with a CUDA card of compute
capability 9.0+ and the CUDA toolkit.  It:

  1. prints the card's name and power limit (nvidia-smi) and the int32
     yardstick: 64 INT32 lanes an SM x the card's SMs x its max SM clock
     (repro_torch.roofline.analysis.int32_ops_per_s), the rate every
     SharedDB kernel's bound and core/sla's HwModel hold int32 work to;
  2. builds the hand-written kernels from src/repro_torch/kernels/csrc
     into build/ (nvcc, one process per source, in parallel), and prints
     ptxas's report (registers, stack and spills of partitioned_join,
     delta_scan, bitmask_join and delta_join) and the HGMMA (wgmma)
     count in the SASS of the tensor-core flash-attention kernel;
  3. holds each of the eight kernels against its plain PyTorch version on
     the card on small edge cases: padded tails, invalid rows, empty
     buckets, an empty dirty set and a zero pane span, idle stages with
     live probes, probe keys past either end of the bounds, pads at every
     slot position, 16 stages and 16 joins in one fused launch, an
     order_line-sized spine with dirty rows on tile seams, the reseed
     beat's six scan shapes and four partitioned joins at full scale,
     duplicate key runs across buckets, keys at INT_SENTINEL - 1, 70 003
     buckets, the chained beat's seven delta_scan stages and four
     delta_join probes in one launch each and 40 stages / joins in two,
     ragged block-join sides staged in shared memory (past 48 KB of it
     too) and past it (the chunked path), an unaligned left mask, the
     fold's block join at full scale, invalid right rows repeating a
     valid key, all-pad dirty sets and dirty rows at T-1; flash attention
     on the reference's five test shapes, ragged S (24, 200), Sq < Sk,
     D 16 and 128, causal Sq > Sk (rows that see no key), and the LM
     paths' prefill shapes (yi-6b's 512 tokens, gemma3-27b's 2048-token
     local and global layers, qwen2-moe-a2.7b's 512 tokens over 16 heads
     and 16 KV heads, recurrentgemma-2b's 512 tokens at D 256 over one KV
     head in a 2048 window, whisper-small's 1536-frame encoder and its
     192-over-1536 cross layer, llama-3.2-vision-90b's 512-over-6404 cross
     layer: the last three not causal) on standard-normal inputs, in
     float32 and bfloat16.  Tolerance: words, rids and group counts bit-equal;
     group sums within rtol 1e-6 (float atomics add in a varying order;
     TPC-W's integer sums are exact); attention within rtol = atol / 5 =
     1e-5 in float32 and 2e-2 in bfloat16 (the reference's own test),
     and at the LM paths' shapes each output row (one query, one head)
     also within FLASH_ROW_REL_TOL of its own norm;
  4. drives five paths at the paper's TPC-W scale (configs/shareddb_tpcw:
     10 000 items, 28 800 customers), each with every kernel's launch
     count set to 0 just before it and read just after:
       dense / indexless — SharedDBEngine on the dense-index and the
         index-less catalog, a reseed beat and slot-stable steady beats of
         the TPC-W shopping mix;
       fold — a QueryCycleServer over the index-less engine folds TPC-W's
         Buy Request address lookup (``address`` joined to ``country``, a
         block join) into the running plan on its background thread while
         beats keep coming, then steady beats with live dirty rows on the
         block join's and the cart join's spines;
       chained — a cold engine compiled with all 14 templates on
         ``hopper-chained`` (the hopper kernels without fused_delta, so the
         delta beat chains 7 pane scans, ONE delta_scan over the 7 stages
         and ONE delta_join over the 4 partitioned joins), replaying the
         fold path's beats;
       sharded — the index-less catalog on row meshes of 1, 2 and 4
         shards, every shard on this card (``SharedDBEngine(mesh=...)``,
         core/sharding.py), beside the unsharded engine, a reseed and 8
         slot-stable steady beats: the 1-shard engine bit-identical to the
         unsharded one (tickets, paths, backend ops, launches, snapshots),
         the 2-shard one bit-identical to its ``jit=False`` twin and
         answering as the unsharded engine (row sets, group scores within
         rtol 1e-6) with one all_gather per mirrored predicated stage in
         the reseed and none in a delta beat, the 4-shard one answering
         alike over 4 beats; a 2-shard engine without order_lines,
         order_display and get_cart folds them in on its
         QueryCycleServer's background thread and answers as the cold
         2-shard engine; ``buy_request_address`` is refused with
         ``fold-mirror-set``; the 2-shard twin's recorded kernel calls
         (shard geometry) are held against their plain versions;
     every engine under test runs graphed (``jit=True``: each beat replays
     a captured CUDA graph; the fold's generation is captured on its fold
     thread), and its capture seconds and graph pool bytes per generation
     are printed; on every beat its tickets must equal, bit for bit, those
     of a ``jit=False`` twin on the same kernels with the same history
     (same paths, backend ops and kernel launches; the twin's launches
     count aside), those of a twin on the plain ``torch`` backend and, on
     a sample, the query-at-a-time engine's; from the migration beat on,
     the folded engine's tickets must equal the cold chained engine's;
     steady beats must take the delta paths with the expected backend
     launches, and ``dispatch()`` must not synchronise with the host (the
     one exemption: the fold's migration beat, which drains in-flight
     beats by design); the last steady beat of each path runs under
     torch.profiler on the engine and its eager twin, for the card's busy
     time and the host ops enqueued, printed graphed beside eager;
       lm-yi-6b — the LM CycleServer on yi-6b at full width and depth (32
         layers, bf16 weights from the port's seeded init): capacity 8,
         max_seq 1024, prefill_len 512, 16 requests of 64-512 prompt
         tokens and 32 new tokens each, run to drain;
       lm-gemma3-27b — gemma3-27b at full width, depth cut to 7 layers
         (one 5:1 local/global group and a leftover local layer, for chip
         time): capacity 4, max_seq 4096, prefill_len 2048 (over the 1024
         window: the ring cache), 4 requests of 16 new tokens;
       lm-qwen2-moe-a2.7b — the MoE server: qwen2-moe-a2.7b at full width
         and depth (24 layers, 60 routed experts top-4 and 4 shared,
         14.3 B parameters, 2.7 B active), yi-6b's traffic; its MoE
         blocks dispatch by sort into capacity-padded expert buffers;
       lm-recurrentgemma-2b — the recurrent program at full width and
         depth (26 layers: 8 groups of two RG-LRU layers and one local
         attention layer at D 256, 10 heads over 1, window 2048, then two
         RG-LRU layers; 2.67 B parameters), yi-6b's traffic;
       lm-mamba2-370m — the SSD program at full width and depth (48
         layers, 0.37 B parameters: a 512-token prefill is two SSD chunks
         of 256), yi-6b's traffic; attention-free, so no kernel runs;
       lm-whisper-small — the encoder-decoder at full width and depth (12
         encoder and 12 decoder layers): capacity 8, max_seq 448 (its
         decoder context), prefill_len 192 over 1536 zero frames, 16
         requests of 16-192 tokens, 32 new each;
       lm-llama-3.2-vision-90b — the cross program at full width (d
         8192, 64 / 8 heads, FFN 28 672, 6404 vision tokens), depth cut
         100 -> 20 layers (4 groups of 4 self and 1 cross: 19.3 B
         parameters, 38.6 GB) to fit the card: capacity 4, max_seq 1024,
         prefill_len 512, 8 requests of 64-512 tokens, 16 new each;
     the servers feed zero frames / vision tokens, as the reference's;
     every prefill layer of the server under test (an encoder's too) is
     re-run with the plain attention from the server's own input to that
     layer, and its output must agree within 2e-2 of the tensor's largest
     magnitude (a recurrent or SSD layer, which runs no kernel, bit for
     bit); of
     a MoE layer, the residual after the attention (its K/V too), and
     its MoE block, re-run from the server's own residual, must give the
     server's output bit for bit (the tokens the plain residual routes
     otherwise are counted, not gated: a near-tie route can flip).
     With random weights at the reference's init scales the attention
     is nearly one-hot (the score spread of a recorded call is printed),
     so the kernel's online-softmax rescaling is held to its plain
     version at these paths' shapes on soft-softmax inputs in step 3.
     Each LM server captures its decode step as a CUDA graph and runs
     beat for beat beside a twin on the same weights whose prefill
     attention is the plain version (kernels="torch") and whose decode
     step runs eagerly (jit=False); the twin gates nothing: it measures
     the end-to-end divergence (one bf16 rounding grows several-fold a
     layer under one-hot attention, and the two reach O(1) within about
     ten layers) and gives the eager beats' walls, printed beside the
     graphed ones.  On every LM path every decode-only beat's graphed step
     is run again eagerly on a copy of the cache taken before the step:
     greedy tokens equal, logits within LM_EAGER_REL_TOL of scale; the
     ``roofline:`` lines give each LM path's model FLOPs
     (roofline.model_flops: active parameters) of its profiled
     admission and decode-only beats over their card busy time, as a
     share of the bf16 peak (information).  Every request must end with its
     tokens and no NaN, and flash_attention must launch once per
     attending sublayer (attention, cross, encoder) per admission, every
     launch on its tensor-core kernel (bf16, D 64 / 128 / 256); one
     admission beat and one decode-only beat of the server and of its
     twin run under torch.profiler;
     between the SharedDB and the LM paths, planlint (``planlint:``
     lines; on the sharded path the collective and locality rules too):
     the construction gate's host time per plan generation of
     each SharedDB engine under test (the fold's second generation gated
     on its fold thread, beside the fold's registration -> commit), the
     kernel passes against the fused_delta descriptor launch_schedule
     cached on the card for each path's generation, the trace passes on
     each path's eager twin (bodies re-run on the torch backend), the
     graphed engine's fixed buffers and the hot-path source pass; any
     error finding fails the run; then the ``sla:`` and ``roofline:``
     lines of the dense, index-less and 2-shard engines: the paper's
     worst-case cycle (core/sla.cycle_cost, H100 HwModel) and
     provision(plan, 3 s) beside the measured reseed wall and a forced,
     profiled reseed's card busy; fused_delta_footprint of the steady
     beat; the 2-shard reseed's collective schedule (3 all-gathers);
     then the ``python -O`` leg (``o_leg_phase``): the process
     ``python -O tests/run_torch_fold_differential.py`` on this card —
     the stripped-assert guards raise with their planlint rule id, the
     fold stream unsharded and on a 2-shard row mesh of this card
     (graphed, hopper kernels) equals a cold engine of the final
     template set, a stale-carry dispatch raises — its ok lines, wall
     and kernel launches printed (each kernel's ``o_leg_launches`` in
     the JSON line), clockscan, shared_groupby and fused_delta launched;
  5. replays recorded kernel inputs (the main paths' own shapes and data)
     through each kernel and its plain version, the plain version first
     (the recorded fused_delta calls also through planlint's kernel
     passes, against the descriptors the card cached for them):
     agreement, then each call's time on the card (torch.profiler: all
     device work of the call, and the hand-written kernel alone), the
     device ops it enqueues (fused_delta may enqueue at most one per join
     beside its launch) and its wall time (a pair of CUDA events per
     call), beside a bound computed from the bytes and operations of
     those inputs; partitioned_join, bitmask_join, delta_scan and
     delta_join once more with the card's L2 cache flushed before every
     call; bitmask_join once more with its right side's rows shuffled
     (staged out of key order: rids by the scan); the recorded
     delta_join buckets must be in the layout its binary search needs;
     flash attention at every (causal, window, Sq, Sk) that an LM path
     launched (yi-6b's 512-token prefill, gemma3-27b's 2048-token
     window-1024 and causal layers, qwen2-moe-a2.7b's 512-token layer,
     recurrentgemma-2b's D-256 layer, whisper-small's encoder, decoder
     and cross layers, llama-3.2-vision-90b's self and cross layers),
     each beside one PyTorch call of the same function
     (scaled_dot_product_attention, with the window band as a boolean
     mask at a window layer; timed here only), and its CUDA-core kernel
     once at yi-6b's call and once at recurrentgemma-2b's; the
     fused_delta footprint's worst-case bound beside the fused_delta row;
     shared_groupby timed GROUPBY_RETIMES more times on its recorded
     call, each time as a share of its bound, beside the previous
     design's median (PREVIOUS_DESIGN_MS), and its parts (the launch
     with no rows, and with no rows and one group, beside a
     ``torch.zeros`` of the packed buffer and of one group's); the
     window of every timing of it must hold at most
     shared_groupby.DEVICE_OPS device ops per launch of its kernel (its
     design, printed with the build: one cooperative launch that zeroes
     and accumulates), and its kernel's float adds must be RED in the
     SASS;
     then the mesh phase (``mesh:`` and ``elastic:`` lines,
     ``mesh_phase``): yi-6b on a (2, 2) mesh of four simulated ranks,
     eager beside the unsharded server and graphed (``jit=True``, the
     decode step one CUDA graph of every rank) beside the eager mesh
     server, every decode beat's logits within MESH_GRAPH_REL_TOL; the
     dry-run's family cells; the elastic shrink of stablelm-1.6b (4 of
     24 layers) from (1, 2, 2) to (1, 1, 2) through a checkpoint
     (``elastic_phase``);
  6. runs the train phase last (``train:`` lines: after its profiled
     step, later torch.profiler sessions in the process traced no device
     event), each path with every launch count set to 0 just before it
     and read just after, none of which may have launched (the
     reference trains through its plain attention; the flash kernel has
     no backward):
       lm-train-stablelm-1.6b — the launcher's default arch at full
         width and depth (24 layers, d 2048, 32 / 32 heads, FFN 5632,
         vocab 100 352; bf16 parameters from the seeded init, float32
         AdamW moments, remat full) at the reference's train_4k sequence
         (4096) and batch 2: 8 steps of the launcher's flow
         (``launch/train.run``, what ``main`` runs) at lr 3e-3 on the
         synthetic pipeline; every loss and gnorm finite, the last loss
         below the first, the optimizer at step 8; the median step
         (steps 2-8), tokens/s, peak memory, one more step under
         torch.profiler (busy and idle share) and its model FLOPs
         (roofline.model_flops, 6 N tokens) as a share of the bf16 peak;
       smoke parity — one float32 train_step of smoke stablelm on the
         card against the same step on the CPU: loss within 1e-5
         relative, every updated parameter and moment within 1e-4 of its
         norm;
       lm-train-mamba2-370m (restart) — full width and depth (48 SSD
         layers, d 1024) at batch 2 x 4096 through the launcher's
         FaultTolerantLoop, checkpoints every 4 steps in a temp dir
         (removed after), 10 steps with a fault injected at step 6: the
         replayed steps 4-5 give the first pass's losses bit for bit,
         the final state equals an uninterrupted run's leaf by leaf, bit
         for bit (the trainer's deterministic algorithms), and a
         checkpoint the card wrote, loaded on the CPU, is bit-equal with
         its crcs checked;
     then flash_attention must raise on CUDA inputs that require grad,
     and the four examples/torch_*.py run as processes of their own at
     their default sizes on the card, each exiting 0 (wall times
     printed); each kernel's entry in the JSON line lists the training
     paths' launch counts (``training_launches``, all 0);
  7. prints one JSON line of per-kernel results, then the one-line device
     record as the last line.

Any failed check raises and the script exits non-zero; with no CUDA
device it exits non-zero before printing any result.  The data is made
from ``SEED`` with numpy.
"""
import contextlib
import functools
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
# H100 SXM (NVIDIA data sheet): 3.35 TB/s HBM3.  The SharedDB kernels'
# int32 compares (none runs on the tensor cores) are held to the CUDA
# cores' int32 rate, repro_torch.roofline.analysis.int32_ops_per_s: 64
# INT32 lanes an SM x the card's SMs x its max SM clock (16.73e12 on an
# H100 SXM, a quarter of the 67 TFLOP/s FP32 rate, which counts an FMA as
# two operations on 128 FP32 lanes)
HBM_BYTES_PER_S = 3.35e12
# bf16 dense tensor-core peak: the rate flash attention's bound is held to
TENSOR_CORE_BF16_FLOPS = 989e12
# each kernel's symbol, as it appears in a profiler trace
KERNEL_SYMBOLS = {"clockscan": "clockscan_kernel",
                  "shared_groupby": "groupby_kernel",
                  "partitioned_join": "partitioned_join_kernel",
                  "fused_delta": "fused_delta_kernel",
                  "bitmask_join": "bitmask_join_kernel",
                  "delta_scan": "delta_scan_kernel",
                  "delta_join": "delta_join_kernel",
                  "flash_attention": "flash_attention_wgmma_kernel"}
# flash attention's CUDA-core kernel (float32, and bf16 at D 16 / 32)
FLASH_SIMT_SYMBOL = "flash_attention_simt_kernel"
# the TPU kernel each replaces (src/repro/kernels, file:line of its
# pallas_call function) and its CUDA source
KERNEL_ORIGIN = {
    "clockscan": ("clockscan.cu", "src/repro/kernels/clockscan.py:61"),
    "shared_groupby": ("shared_groupby.cu",
                       "src/repro/kernels/shared_groupby.py:66"),
    "partitioned_join": ("partitioned_join.cu",
                         "src/repro/kernels/partitioned_join.py:74"),
    "fused_delta": ("fused_delta.cu", "src/repro/kernels/fused_delta.py:303"),
    "bitmask_join": ("bitmask_join.cu",
                     "src/repro/kernels/bitmask_join.py:80"),
    "delta_scan": ("fused_delta.cu", "src/repro/kernels/fused_delta.py:377"),
    "delta_join": ("fused_delta.cu", "src/repro/kernels/fused_delta.py:421"),
    "flash_attention": ("flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:91"),
}
# the kernels each path must launch
PATH_KERNELS = {
    "dense": ("clockscan", "shared_groupby", "fused_delta"),
    "indexless": ("clockscan", "shared_groupby", "partitioned_join",
                  "fused_delta"),
    "fold": ("clockscan", "shared_groupby", "partitioned_join",
             "fused_delta", "bitmask_join"),
    "chained": ("clockscan", "shared_groupby", "partitioned_join",
                "bitmask_join", "delta_scan", "delta_join"),
    "sharded": ("clockscan", "shared_groupby", "partitioned_join",
                "fused_delta"),
    "lm-yi-6b": ("flash_attention",),
    "lm-gemma3-27b": ("flash_attention",),
    "lm-qwen2-moe-a2.7b": ("flash_attention",),
    "lm-recurrentgemma-2b": ("flash_attention",),
    "lm-mamba2-370m": (),           # attention-free: no kernel on its path
    "lm-whisper-small": ("flash_attention",),
    "lm-llama-3.2-vision-90b": ("flash_attention",),
}
# flash attention at the LM paths' shapes on standard-normal inputs: the
# largest ||kernel - plain|| / ||plain|| over output rows (one query, one
# head).  The kernel's tile loop replayed on the CPU stays under a quarter
# of it, and goes over ten times it with one key tile of one query tile
# left out (tests/test_torch_flash.py
# ::test_row_relative_gate_separates_roundoff_from_a_dropped_key_tile)
FLASH_ROW_REL_TOL = 2e-2
N_INTERACTIONS = 150        # web interactions in the reseed beat
STEADY_BEATS = 3            # unprofiled steady beats, then one profiled
SAMPLE_PER_BEAT = 12        # tickets checked against query-at-a-time
FOLD_CAP = 16               # buy_request_address slots (fixed addresses)
FOLD_MAX_S, FOLD_MAX_BEATS = 60.0, 200   # the fold must commit within
FUSED_STEADY = {"fused_delta": 1, "groupby": 1}
# (C, T, Q) of the reseed beat's six clockscan calls at full scale:
# customer, item, author, order_line, orders, shopping_cart_line
CLOCKSCAN_MAIN = ((2, 43200, 96), (3, 12048, 352), (1, 3524, 224),
                  (1, 116640, 96), (2, 38880, 128), (1, 43200, 32))
# device ms of a timed set of the previous design of each redesigned
# SharedDB kernel, as PERF.md §6 records them (NVIDIA H100 80GB HBM3,
# 700 W): clockscan a warp per row; fused_delta a block per descriptor
# row with its gathers in torch ops; partitioned_join a warp per left row
# scanning its whole bucket; delta_scan one launch per stage, 7 a chained
# beat; bitmask_join a block of 256 left rows, a word a thread; delta_join
# one launch per join, 4 a chained beat, a warp per slot scanning its
# bucket; shared_groupby two torch.zeros fills then the set-bit kernel
# (the median of twelve timings); printed beside this run's
PREVIOUS_DESIGN_MS = {"clockscan": 0.090982, "fused_delta": 0.090253,
                      "partitioned_join": 0.101247, "delta_scan": 0.010399,
                      "bitmask_join": 0.010078, "delta_join": 0.009237,
                      "shared_groupby": 0.005649}
CHAINED_STEADY = {"scan": 7, "scan_delta": 1, "join_delta": 1, "groupby": 1}
# (T, C, Q, D) of a chained steady beat's seven predicated stages at full
# scale: customer, item, author, order_line, orders, shopping_cart_line,
# address (14 templates, the index-less catalog)
DELTA_SCAN_MAIN = ((43200, 2, 96, 128), (12048, 3, 352, 128),
                   (3524, 1, 224, 128), (116640, 1, 96, 128),
                   (38880, 2, 128, 128), (43200, 1, 32, 128),
                   (51392, 1, 64, 128))
# (Tl, Tr, P) of its four partitioned joins (item x author, order_line x
# orders, order_line x item, shopping_cart_line x item), B 256, D 128
DELTA_JOIN_MAIN = ((12048, 3524, 14), (116640, 38880, 152),
                   (116640, 12048, 48), (43200, 12048, 48))
# profiled windows device_ms tries before it takes a trace without any
# event of the kernel as the trace's answer
PROFILE_ATTEMPTS = 3
# bytes written between two calls to flush the card's 50 MB L2 cache
L2_FLUSH_BYTES = 128 * 2 ** 20


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


# ----------------------------------------------------------------- helpers
def clone_tree(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone_tree(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(clone_tree(v) for v in x)
    return x


def wall_ms(fn, setup=None, reps=30):
    """Median milliseconds of one call of ``fn`` between its own pair of
    CUDA events, after a warm-up: what a caller waits for, host enqueue
    (checks, allocation, launch) and device time together.  ``setup``
    runs before each call, outside its window."""
    import torch
    samples = []
    for i in range(reps + 3):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= 3:
            samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def device_ms(fn, kernel, setup=None, reps=20, launches=1):
    """Time on the card per call of ``fn``, from a torch.profiler trace:
    (all device work that the call launched, that of the kernels whose
    name holds ``kernel``, launches of those kernels per call).

    Each call runs inside its own ``record_function`` range; the device
    work of a call is every kernel, copy and fill linked to that range or
    to an op inside it; kernels launched through ctypes are linked to no
    range.  The trace loses events of a window (up to half of a
    one-launch kernel's), so the work other than ``kernel`` is the mean
    over the calls whose ranges hold the most device work items (the
    whole calls), and ``kernel``'s is the mean of its events in the trace
    times ``launches``, the launches of it that one call of ``fn`` makes
    (0 for a function that launches none).  ``setup`` runs before each
    call, outside the range.  The third value is the events of
    ``kernel`` that the trace holds per call, the fourth the device ops
    (kernels, copies, fills) that one whole call enqueues, the fifth
    every device op of the window, linked to a range or not (so also
    what a library launched through ctypes enqueues besides its kernel),
    per event of ``kernel`` that the trace kept, times ``launches``: the
    device ops a call, counted against the kernel's events because the
    trace loses some of every kind (per call where ``fn`` launches no
    kernel).  A trace that
    holds no device event, or none of ``kernel`` where ``fn`` launches
    it, is taken again, up to PROFILE_ATTEMPTS windows: now and then a
    trace comes back without them."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    for _ in range(3):
        if setup is not None:
            setup()
        fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if setup is not None:
                    setup()
                with record_function("chip_smoke.call"):
                    fn()
            torch.cuda.synchronize()
        events = prof.events()
        names = [e.name for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names and (not launches or any(kernel in n for n in names)):
            break
        print(f"profiler: no device event{' of ' + kernel if names else ''}"
              f" in the trace (attempt {attempt + 1} of "
              f"{PROFILE_ATTEMPTS})")

    def linked(ev):
        yield from ev.kernels
        for ch in ev.cpu_children:
            yield from linked(ch)
    cpu = torch.autograd.DeviceType.CPU
    calls = [e for e in events
             if e.name == "chip_smoke.call" and e.device_type == cpu]
    if len(calls) != reps:
        fail(f"profiler: {len(calls)} call ranges, not {reps}")
    per = [[k.duration for k in linked(c) if kernel not in k.name]
           for c in calls]
    whole = [p for p in per if len(p) == max(map(len, per))]
    own = [e.time_range.elapsed_us() for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and kernel in e.name]
    own_us = sum(own) / len(own) * launches if own else 0.0
    other_us = sum(map(sum, whole)) / len(whole)
    window = sum(e.device_type == torch.autograd.DeviceType.CUDA
                 and e.name != "chip_smoke.call" for e in events)
    return ((other_us + own_us) / 1e3, own_us / 1e3, len(own) / reps,
            len(whole[0]) + launches,
            window / len(own) * launches if own and launches
            else window / reps)


def cold_l2_ms(fn, name, flush):
    """The kernel's own device time in one call of ``fn`` with the card's
    L2 cache flushed before every call (``flush`` written over, outside
    the timed range): what a caller that finds its inputs in HBM pays."""
    return device_ms(fn, KERNEL_SYMBOLS[name], setup=flush.zero_)[1]


def bound_ms(nbytes, nops, ops_per_s=None):
    """The least milliseconds the card could take: bytes over HBM, or
    operations over ``ops_per_s`` (default the CUDA cores' int32 rate),
    whichever is larger, and which of the two it is."""
    from repro_torch.roofline.analysis import int32_ops_per_s
    ops_per_s = int32_ops_per_s() if ops_per_s is None else ops_per_s
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def max_abs_err(a, b):
    """Largest |a - b| over two results (int32 words compared as their
    uint32 values)."""
    import torch
    if isinstance(a, (tuple, list)):
        return max([max_abs_err(x, y) for x, y in zip(a, b)] + [0.0])
    if a.dtype == torch.int32:
        a, b = a.to(torch.int64) & 0xFFFFFFFF, b.to(torch.int64) & 0xFFFFFFFF
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def row_rel_err(got, want):
    """||got - want|| / ||want|| of each row of the last axis, in float32
    (a zero row of ``want`` divides by 1e-30)."""
    d = (got.float() - want.float()).norm(dim=-1)
    return d / want.float().norm(dim=-1).clamp_min(1e-30)


def same(a, b, what):
    """Bit-equal tensors / tuples of tensors, or fail."""
    import torch
    if isinstance(a, (tuple, list)):
        if len(a) != len(b):
            fail(f"{what}: {len(a)} outputs vs {len(b)}")
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{what}[{i}]")
        return
    if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
        fail(f"{what}: kernel and plain version differ "
             f"(max abs err {max_abs_err(a, b)})")


# ---------------------------------------------------- 3. small edge cases
def edge_cases(dev):
    import numpy as np
    import torch
    from repro_torch.core.backends import (DeltaJoinIn, DeltaScanIn,
                                           FusedJoinIn, FusedScanIn)
    from repro_torch.core.storage import INT_SENTINEL, build_key_partitions
    from repro_torch.kernels import (bitmask_join, clockscan, fused_delta,
                                     partitioned_join, ref, shared_groupby)

    rng = np.random.default_rng(SEED)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def words(shape):
        return t(rng.integers(0, 2 ** 32, shape, dtype=np.uint64)
                 .astype(np.uint32).view(np.int32))

    # clockscan: a padded tail (T % 256 != 0), invalid rows, 1..3 columns;
    # the reseed beat's six scans at full scale (CLOCKSCAN_MAIN); one row,
    # one row past a warp's tile, 8191 rows
    for C, T, Q in ((1, 256, 32), (3, 515, 64), (2, 300, 416),
                    *CLOCKSCAN_MAIN, (2, 1, 64), (1, 33, 32), (3, 8191, 416)):
        cols = t(rng.integers(-50, 100, (C, T)))
        lo = t(rng.integers(-60, 50, (C, Q)))
        hi = lo + t(rng.integers(0, 80, (C, Q)))
        valid = t(rng.random(T) > 0.15, torch.bool)
        same(clockscan.clockscan(cols, lo, hi, valid),
             ref.clockscan_ref(cols, lo, hi, valid), f"clockscan {C}x{T}x{Q}")
    # shared_groupby: out-of-range codes contribute nothing; no rows (the
    # kernel still zeroes the outputs), one group, a grid whose last
    # stripe is ragged
    for T, W, G in ((512, 1, 50), (700, 2, 100), (0, 2, 30), (300, 1, 1),
                    (5000, 3, 4097)):
        codes = t(rng.integers(-2, G + 2, T))
        vals = t(rng.integers(1, 10, T))
        mask = words((T, W))
        c1, s1 = shared_groupby.shared_groupby(codes, vals, mask, G)
        c2, s2 = ref.shared_groupby_ref(codes, vals, mask, G)
        same(c1, c2, "shared_groupby counts")
        if not torch.allclose(s1, s2, rtol=1e-6):
            fail("shared_groupby sums")
    # partitioned_join: empty buckets, all-invalid right sides, duplicate
    # runs across buckets (keys drawn from `span` values), left keys below
    # the first bound, past the last and at INT_SENTINEL - 1; Tl 1, 31,
    # 33, 129; W 1, 13, 40; a P whose bounds outgrow shared memory; the
    # reseed beat's four joins at full scale (B 256, W 13)
    for Tr, Tl, W, frac, B, extra, span in (
            (160, 120, 2, 0.8, 48, 0, 0), (130, 300, 1, 0.2, 7, 3, 0),
            (64, 64, 3, 0.0, 16, 1, 0), (257, 129, 13, 1.0, 32, 0, 0),
            (200, 129, 13, 0.9, 8, 0, 12), (130, 33, 1, 0.2, 7, 3, 0),
            (64, 31, 40, 0.0, 16, 1, 0), (5, 1, 13, 1.0, 2, 2, 0),
            (100, 129, 40, 0.8, 16, 2, 30), (70000, 4097, 2, 0.9, 1, 3, 0),
            (3524, 12048, 13, 0.95, 256, 0, 0),
            (38880, 116640, 13, 0.95, 256, 0, 0),
            (12048, 116640, 13, 0.95, 256, 1, 0),
            (12048, 43200, 13, 0.95, 256, 1, 0)):
        keys_r = rng.integers(-2, span or Tr, Tr)     # with duplicates
        keys_r[:min(2, Tr)] = INT_SENTINEL - 1
        valid_r = rng.random(Tr) < frac
        kl = rng.choice(np.concatenate([keys_r, keys_r + 1]), Tl)
        edges = [INT_SENTINEL - 1, int(keys_r.min()) - 5, -2 ** 31,
                 INT_SENTINEL, int(keys_r.max()) + 1]
        kl[:min(Tl, 5)] = edges[:Tl]
        parts = build_key_partitions(t(keys_r), t(valid_r, torch.bool),
                                     -(-Tr // B) + extra, B)
        kl, ml, mr = t(kl), words((Tl, W)), words((Tr, W))
        same(partitioned_join.partitioned_join(kl, ml, *parts, mr),
             ref.partitioned_join_ref(kl, ml, *parts, mr),
             f"partitioned_join {Tr}x{Tl}x{W} P={parts[0].shape[0]}")

    # fused_delta: mixed stages / joins, pane-seam dirty rows, the dn == 0
    # / span == 0 identity, idle stages with live probes, probe keys past
    # either end of the bounds, pads at every slot position, MAX_STAGES
    # and MAX_JOINS, and an order_line-sized spine with dirty rows on the
    # pane-tile and copy-tile seams
    def scan(T, C, Q, A, D, dn, span, seam=()):
        cols = t(rng.integers(0, 50, (C, T)))
        lo = t(rng.integers(0, 30, (C, Q)))
        hi = lo + t(rng.integers(0, 30, (C, Q)))
        w0 = int(rng.integers(0, Q // 32 - A + 1))
        pool = [r for r in seam if r < T]
        rest = [r for r in rng.permutation(T) if r not in pool]
        rows = np.sort(np.asarray(pool + rest, np.int64)[:dn])
        rows = np.concatenate([rows, np.full(D - dn, T)])
        return FusedScanIn(
            cols, lo, hi, lo[:, w0 * 32:(w0 + A) * 32].contiguous(),
            hi[:, w0 * 32:(w0 + A) * 32].contiguous(),
            t(rng.random(T) < 0.9, torch.bool), words((T, Q // 32)),
            t(w0), t(span), t(rows), t(dn))

    def join(Tl, Tr, D, dn, pseudo=False, seam=()):
        kr = t(rng.permutation(Tr))
        vr = t(rng.random(Tr) < 0.9, torch.bool)
        if pseudo:
            parts = (torch.where(vr, kr, INT_SENTINEL)[None],
                     torch.where(vr, torch.arange(Tr, device=dev,
                                                  dtype=torch.int32),
                                 -1)[None],
                     t([-2147483647]))
        else:
            parts = build_key_partitions(kr, vr, 2, Tr // 2 + 8)
        pool = [r for r in seam if r < Tl]
        rest = [r for r in rng.choice(Tl, min(Tl, dn + len(pool)), False)
                if r not in pool]
        rows = np.sort(np.asarray(pool + rest, np.int64)[:dn])
        rows = np.concatenate([rows, np.full(D - dn, Tl)])
        return FusedJoinIn(t(rng.integers(0, Tr, Tl)), t(rows), t(dn),
                           *parts, t(rng.integers(-1, Tr, Tl)))

    def route_edges(e):
        """Probe keys below the first bound, above the last and at the
        int32 extremes, on the first four dirty rows."""
        lo_b, hi_b = int(e.bounds[0]), int(e.bounds[-1])
        keys = e.keys.clone()
        for r, k in zip(e.rows.long()[:4],
                        (max(lo_b, -2 ** 31 + 1) - 1, -2 ** 31, 2 ** 31 - 1,
                         min(hi_b, 2 ** 31 - 2) + 1)):
            keys[r] = k
        return e._replace(keys=keys)

    OL = 116640
    cases = {
        "mixed": ((scan(300, 2, 64, 1, 8, 5, 1), scan(256, 3, 96, 2, 16, 0, 0),
                   scan(700, 1, 32, 1, 4, 4, 1)),
                  (join(300, 128, 8, 3), join(256, 64, 8, 8, pseudo=True))),
        "seams": ((scan(300, 2, 64, 1, 8, 5, 1, seam=(0, 255, 256, 299)),),
                  (join(300, 64, 4, 2),)),
        "identity": ((scan(128, 2, 64, 2, 8, 0, 0),),
                     (join(128, 32, 4, 0),)),
        # block joins as single-bucket pseudo-partitions (P = 1, B = the
        # PK capacity) with live dirty rows
        "block": ((scan(500, 1, 32, 1, 16, 3, 1),),
                  (join(500, 128, 16, 7, pseudo=True),
                   join(500, 100, 16, 2, pseudo=True))),
        "idle stages, live probes": (
            (scan(300, 2, 64, 1, 8, 0, 0), scan(700, 1, 32, 1, 4, 0, 0)),
            (join(300, 128, 8, 5), join(256, 64, 8, 8, pseudo=True))),
        "route edges": ((), (route_edges(join(400, 160, 8, 6)),
                             route_edges(join(400, 160, 8, 6, pseudo=True)))),
        # the first pad at every slot position; an all-pad set with dn 1
        "pads": (tuple(scan(200, 1, 32, 1, 8, n, 1) for n in range(9))
                 + (scan(200, 2, 64, 1, 8, 0, 1)._replace(dn=t(1)),),
                 tuple(join(200, 64, 8, n, pseudo=n % 2 == 1)
                       for n in range(9))
                 + (join(200, 64, 8, 0)._replace(dn=t(1)),)),
        "max stages and joins": (
            tuple(scan(100 + 37 * s, 1 + s % 3, 32 * (1 + s % 4), 1, 8, s % 6,
                       s % 2) for s in range(fused_delta.MAX_STAGES)),
            tuple(join(100 + 53 * j, 64 + j, 8, j % 6, pseudo=j % 2 == 1)
                  for j in range(fused_delta.MAX_JOINS))),
        "order_line spine": (
            (scan(OL, 1, 96, 1, 128, 6, 1,
                  seam=(0, 255, 256, 1023, 1024, OL - 1)),),
            (join(OL, 12048, 128, 8, seam=(0, 1023, 1024, 2047, 2048,
                                           OL - 1)),)),
    }
    for name, (si, ji) in cases.items():
        want = ref.fused_delta_ref(si, ji)
        got = fused_delta.fused_delta(clone_tree(si), clone_tree(ji))
        same(got, want, f"fused_delta {name}")
        if name == "identity":
            same(got[0][0], si[0].carry, "fused_delta span==0/dn==0 words")
            same(got[1][0], ji[0].rid_carry, "fused_delta dn==0 rids")

    # bitmask_join: ragged sides, Tr past the 1024 of the reference's
    # tests; right sides staged in shared memory (their keys shuffled, so
    # rids by the scan; past 48 KB of it: 500 x 24, 1500 x 14) and too
    # large for it (500 x 60 words, 12 000 x 1 and 2048 x 14, past
    # STAGE_BYTES: the chunked path); invalid right rows that repeat a
    # valid key (right keys are unique among VALID rows); the fold's
    # migration shape at full scale; an unaligned mask_l (a view some
    # words into a buffer) on both paths
    for Tl, Tr, W, off in ((300, 100, 3, 0), (777, 1500, 14, 0),
                           (200, 2500, 2, 0), (300, 500, 24, 0),
                           (2100, 500, 60, 0), (300, 12000, 1, 0),
                           (1, 1, 1, 0),
                           (51392, 128, 14, 0), (1000, 128, 14, 1),
                           (1000, 2048, 14, 3)):
        keys_r = rng.permutation(Tr * 3)[:Tr]
        valid_r = rng.random(Tr) > 0.25
        inv, val = np.flatnonzero(~valid_r), np.flatnonzero(valid_r)
        n = min(inv.size, val.size)
        keys_r[inv[:n]] = keys_r[rng.choice(val, n, replace=False)]
        kl = rng.choice(Tr * 4, Tl)
        kl[:min(Tl, n)] = keys_r[inv[:min(Tl, n)]]
        ml = words((Tl * W + off,))[off:].view(Tl, W)
        args = (t(kl), ml, t(keys_r), words((Tr, W)), t(valid_r, torch.bool))
        same(bitmask_join.bitmask_join(*args), ref.bitmask_join_ref(*args),
             f"bitmask_join {Tl}x{Tr}x{W} offset {off}")
    # a PK side holding its live rows in key order ahead of its free rows
    # (the fold's country: 92 of 128), searched as staged, without a sort
    for Tl, Tr, W, live in ((51392, 128, 14, 92), (1000, 512, 3, 512),
                            (33, 64, 1, 0)):
        keys_r = np.zeros(Tr, np.int64)
        keys_r[:live] = np.sort(rng.choice(4 * Tr, live, replace=False))
        kl = rng.choice(np.concatenate([keys_r, keys_r + 1, [-2 ** 31]]), Tl)
        args = (t(kl), words((Tl, W)), t(keys_r), words((Tr, W)),
                t(np.arange(Tr) < live, torch.bool))
        same(bitmask_join.bitmask_join(*args), ref.bitmask_join_ref(*args),
             f"bitmask_join {Tl}x{Tr}x{W}, {live} live rows in key order")

    # delta_scan / delta_join: pad slots clamp to row T-1, all-pad and
    # full dirty sets, the last row dirty
    def dirty(T, D, dn):
        rows = np.sort(np.concatenate([[T - 1], rng.permutation(T - 1)])[:dn])
        return t(np.concatenate([rows, np.full(D - dn, T)]))

    def stage(T, C, Q, D, dn):
        lo = t(rng.integers(0, 30, (C, Q)))
        return DeltaScanIn(t(rng.integers(0, 50, (C, T))), lo,
                           lo + t(rng.integers(0, 30, (C, Q))),
                           t(rng.random(T) < 0.9, torch.bool), dirty(T, D, dn))

    # delta_scan: one stage a call, then each set in one grouped call:
    # the four stages together, the chained beat's seven at full scale,
    # and more stages than one launch's argument block holds (D 0 among
    # them, in two launches)
    small = [stage(*x) for x in ((300, 2, 64, 16, 5), (257, 3, 96, 8, 0),
                                 (1000, 1, 416, 128, 4), (64, 2, 32, 8, 8))]
    chained = [stage(T, C, Q, D, 3 + 2 * i)
               for i, (T, C, Q, D) in enumerate(DELTA_SCAN_MAIN)]
    many = [stage(40 + 7 * s, 1 + s % 3, 32 * (1 + s % 4), 4 * (s % 4),
                  min(s % 5, 4 * (s % 4)))
            for s in range(fused_delta.DELTA_SCAN_STAGES + 8)]
    for name, group in [(f"stage {i}", [e]) for i, e in enumerate(small)] \
            + [("4 stages", small), ("chained beat", chained),
               (f"{len(many)} stages", many)]:
        same(fused_delta.delta_scan(group), ref.delta_scans_ref(group),
             f"delta_scan {name}")
    # delta_join: one join a call (P buckets of B, or one bucket of the
    # whole right side), then each set in one grouped call: the four
    # together, the chained beat's four at full scale and more joins than
    # one argument block holds (duplicate-key runs across buckets, D 0
    # among them); the buckets in build_key_partitions' layout, as its
    # binary search needs
    def probe(Tl, Tr, D, dn, P, B, span=0):
        keys_r = rng.permutation(Tr * 3)[:Tr] - 2 if not span \
            else rng.integers(0, span, Tr)
        kl = rng.choice(np.concatenate([keys_r, keys_r + 1]), Tl)
        kl[-3:] = [int(keys_r.min()) - 5, -2 ** 31, INT_SENTINEL - 1]
        parts = build_key_partitions(t(keys_r), t(rng.random(Tr) < 0.9,
                                                   torch.bool), P, B)
        if not partitioned_join.buckets_ordered(parts[0], parts[1]):
            fail("delta_join edge case: buckets not in the searched layout")
        return DeltaJoinIn(t(kl), dirty(Tl, D, dn), *parts)

    small = [probe(300, 160, 16, 5, 2, 88), probe(128, 64, 8, 0, 2, 40),
             probe(5000, 128, 128, 6, 1, 128), probe(64, 100, 8, 8, 1, 100)]
    chained = [probe(Tl, Tr, 128, 3 + 2 * i, P, 256)
               for i, (Tl, Tr, P) in enumerate(DELTA_JOIN_MAIN)]
    many = [probe(40 + 9 * j, 30 + 5 * j, 4 * (j % 4),
                  min(j % 5, 4 * (j % 4)),
                  -(-(30 + 5 * j) // (8 + 8 * (j % 3))), 8 + 8 * (j % 3),
                  12 if j % 7 == 0 else 0)
            for j in range(fused_delta.DELTA_JOINS + 8)]
    for name, group in [(f"join {i}", [e]) for i, e in enumerate(small)] \
            + [("4 joins", small), ("chained beat", chained),
               (f"{len(many)} joins", many)]:
        same(fused_delta.delta_join(group), ref.delta_joins_ref(group),
             f"delta_join {name}")
    flash_edge_cases(dev, rng)
    torch.cuda.synchronize()


# (B, Sq, Sk, H, KV, D, causal, window): tests/test_kernels.py's five,
# then ragged S, Sq < Sk, Sq > Sk (causal: rows that see no key), D 16,
# then the LM paths' own prefill shapes (FLASH_LM_SHAPES): yi-6b's,
# gemma3-27b's local (window 1024) and global layers, qwen2-moe-a2.7b's
# (MHA: 16 heads over 16), recurrentgemma-2b's (D 256, 10 heads over 1,
# window 2048 over 512 tokens), whisper-small's encoder (1536 frames, not
# causal) and cross layer (192 over 1536), llama-3.2-vision-90b's cross
# layer (512 over 6404 vision tokens)
FLASH_LM_SHAPES = (
    (1, 512, 512, 32, 4, 128, True, 0),
    (1, 2048, 2048, 32, 16, 128, True, 1024),
    (1, 2048, 2048, 32, 16, 128, True, 0),
    (1, 512, 512, 16, 16, 128, True, 0),
    (1, 512, 512, 10, 1, 256, True, 2048),
    (1, 1536, 1536, 12, 12, 64, False, 0),
    (1, 192, 1536, 12, 12, 64, False, 0),
    (1, 512, 6404, 64, 8, 128, False, 0),
)
FLASH_EDGE = (
    (1, 128, 128, 4, 4, 64, True, 0), (2, 256, 256, 8, 2, 64, True, 0),
    (2, 256, 256, 8, 4, 32, True, 64), (1, 128, 256, 4, 1, 128, False, 0),
    (2, 128, 128, 4, 4, 64, True, 32),
    (1, 24, 24, 4, 2, 16, True, 0), (1, 200, 200, 8, 2, 128, True, 0),
    (2, 100, 300, 4, 2, 64, True, 0), (1, 300, 100, 4, 4, 128, True, 0),
    (1, 200, 70, 2, 1, 16, True, 16), (1, 77, 130, 4, 4, 32, False, 20),
) + FLASH_LM_SHAPES


def flash_edge_cases(dev, rng):
    """Flash attention against its plain version, float32 at rtol 1e-5 /
    atol 5e-5 and bfloat16 at 2e-2 / 1e-1; finite everywhere (the rows
    that see no key average v, they are not NaN).  Standard-normal q, k,
    v give scores of unit spread, a soft softmax, whose outputs average
    many keys and are small (~sqrt(1/keys) an element), so the elementwise
    atol can pass a lost key tile; at the LM paths' shapes
    (FLASH_LM_SHAPES) each output row is also held to FLASH_ROW_REL_TOL of
    its own norm: that is
    the gate on the kernel's online-softmax rescaling and tile skipping,
    which the paths' own one-hot attention (random weights) hardly
    exercises."""
    import torch
    from repro_torch.kernels import flash_attention as fa, ref
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for B, Sq, Sk, H, KV, D, causal, window in FLASH_EDGE:
            q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=dtype,
                                       device=dev)
                       for s in ((B, Sq, H, D), (B, Sk, KV, D),
                                 (B, Sk, KV, D)))
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
            what = f"flash_attention {dtype} {(B, Sq, Sk, H, KV, D)} " \
                f"causal={causal} window={window}"
            if got.dtype != dtype or not torch.isfinite(got).all():
                fail(f"{what}: dtype {got.dtype} or non-finite values")
            if not torch.allclose(got.float(), want.float(), rtol=tol,
                                  atol=5 * tol):
                fail(f"{what}: max abs err {max_abs_err(got, want)}")
            if (B, Sq, Sk, H, KV, D, causal, window) in FLASH_LM_SHAPES:
                worst = float(row_rel_err(got, want).max())
                print(f"{what}: max abs err {max_abs_err(got, want)}, "
                      f"largest row-relative err {worst}")
                if worst > FLASH_ROW_REL_TOL:
                    fail(f"{what}: an output row is {worst} of its norm "
                         f"off, over {FLASH_ROW_REL_TOL}")


# ------------------------------------------------------ 4. the main path
def beat_profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def busy_ms(prof, top=6):
    """Milliseconds in which the card ran anything (the union of the
    trace's kernel, copy and fill intervals), the count of those, and the
    ``top`` names by device time as [name, ms, count]."""
    import torch
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in dev:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return busy / 1e3, len(spans), [[k[:90], ms, n]
                                    for k, (ms, n) in ranked]


def tickets_equal(a, b, what):
    import numpy as np
    for k, want in b.result.items():
        got = a.result[k]
        if k == "scores":
            if not np.allclose(got, want, rtol=1e-6):
                fail(f"{what} {a.template}.{k}: {got[:4]} vs {want[:4]}")
        elif not np.array_equal(got, want):
            fail(f"{what} {a.template}.{k}: {got[:4]} vs {want[:4]}")


def matches_baseline(t, want, what):
    import numpy as np
    if "rows" in want:
        got = set(int(x) for x in t.result["rows"] if x >= 0)
        exp = set(int(x) for x in want["rows"] if x >= 0)
        if got != exp:
            fail(f"{what} {t.template} {t.params}: query-at-a-time differs")
    elif not np.allclose(np.sort(t.result["scores"]), np.sort(want["scores"]),
                         rtol=1e-6):
        fail(f"{what} {t.template}: group scores differ from query-at-a-time")


def workload(scale_i, scale_c):
    """The reseed beat's queries and updates (TPC-W shopping mix, at most
    one beat's slot capacity per template) and the steady beats' customer
    updates, from SEED."""
    import numpy as np
    from repro_torch.workloads import tpcw
    gen = tpcw.WorkloadGenerator(np.random.default_rng(SEED), scale_i,
                                 scale_c)
    caps = tpcw.make_templates(0)[1]
    queries, updates, per = [], [], {}
    for it in gen.sample_mix("shopping", N_INTERACTIONS):
        updates += it.updates
        for name, params in it.queries:
            if per.get(name, 0) < caps[name]:
                per[name] = per.get(name, 0) + 1
                queries.append((name, params))
    steady = []
    for b in range(STEADY_BEATS + 1):
        steady.append([("customer", "update",
                        {"key": int(gen.rng.integers(0, scale_c)),
                         "col": "c_expiration",
                         "val": int(gen.rng.integers(12000, 15000))})
                       for _ in range(4)])
    return queries, updates, steady


def drive(dense, dev, scale_i, scale_c, kernels, check=True, jit=True,
          recorder=None, armed=(), keep=None):
    """Build the engine under test (backend ``kernels``, graphed unless
    ``jit=False``) for one catalog and run the beats; with ``check``,
    also its ``jit=False`` twin, the plain-backend engine and the
    query-at-a-time engine it is compared with.  ``recorder`` is armed
    with ``armed`` once the engine is built, so it keeps the beats'
    calls and not those of the throwaway full beat on an empty state
    that sizes the engine's buffers.  ``keep`` (a dict) receives the
    engine and its twin for the planlint phase.  Returns the per-beat
    log."""
    import numpy as np
    import torch
    from repro_torch.core.baseline import QueryAtATimeEngine
    from repro_torch.core.executor import SharedDBEngine
    from repro_torch.workloads import tpcw

    data = tpcw.generate_data(np.random.default_rng(SEED), scale_i, scale_c)
    plan = tpcw.build_tpcw_plan(scale_i, scale_c, dense_pk_index=dense)
    eng = SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS, data,
                         kernels=kernels, device=dev, jit=jit)
    if recorder is not None:
        recorder.armed = set(armed)
    if not check:
        return _beats(eng, None, None, None, scale_i, scale_c, dense)
    print_capture("dense" if dense else "indexless", eng)
    eager = SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS, data,
                           kernels=kernels, device=dev, jit=False)
    plain = SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS, data,
                           kernels="torch", device=dev)
    base = QueryAtATimeEngine(plan, data, device=dev)
    if keep is not None:
        keep.update(eng=eng, eager=eager)
    return _beats(eng, eager, plain, base, scale_i, scale_c, dense)


def print_capture(path, eng):
    """Each plan generation's warm-up and capture seconds, graphs and
    graph pool bytes; fails unless the engine runs graphed."""
    if not eng.graphed:
        fail(f"{path}: the engine under test does not run graphed")
    for st in eng.capture_stats:
        print(f"capture, {path} generation {st['generation']}: "
              f"{st['graphs']} graphs, warm-up {st['warmup_s']:.3f} s, "
              f"capture {st['capture_s']:.3f} s, graph pool "
              f"{st['pool_bytes'] / 2 ** 20:.1f} MiB")


def slot_stable(queries, beat, scale_c):
    """The reseed beat's queries in the same slots, one get_customer query
    re-parameterised per beat (``beat`` > 0)."""
    qs = list(queries)
    i = next(k for k, (n, _) in enumerate(qs) if n == "get_customer")
    c = (beat * 7919) % scale_c
    qs[i] = ("get_customer", {0: (c, c)})
    return qs


def timed_beat(eng, profiled, exempt=False, aside=False):
    """One heartbeat of an engine: dispatch, then collect.
    ``dispatch()`` runs under ``set_sync_debug_mode("error")``, so any
    host synchronisation in it raises, unless ``exempt``.  ``aside``: the
    engine is a twin, whose launches count in a record of their own, not
    in the path's counts.  Returns (wall seconds, the profiler or None,
    the beat's kernel launches)."""
    import torch
    from repro_torch import kernels as K
    # the serving stream, not the device: a fold thread may be capturing
    # graphs on a stream of its own, and a device-wide synchronise during
    # a capture is refused (and breaks the capture)
    torch.cuda.current_stream().synchronize()
    before = dict(K.LAUNCHES)
    prof = beat_profiler() if profiled else contextlib.nullcontext()
    with prof, (K.recording() if aside
                else contextlib.nullcontext()) as record:
        t0 = time.perf_counter()
        if exempt:
            eng.dispatch()
        else:
            torch.cuda.set_sync_debug_mode("error")
            try:
                eng.dispatch()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        eng.collect()
        wall = time.perf_counter() - t0
    launches = record.launches if aside else {
        k: n - before[k] for k, n in K.LAUNCHES.items() if n != before[k]}
    return wall, (prof if profiled else None), launches


# the CUDA runtime calls by which the host enqueues device work, as the
# profiler names them on the host's side of the trace
HOST_OP_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
                 "cudaGraphLaunch", "cuGraphLaunch")


def host_ops(prof):
    """The device ops the host enqueued in a profiled window: its kernel
    launches, copies, fills and graph launches, by runtime call."""
    import torch
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and \
                e.name in HOST_OP_CALLS:
            out[e.name] = out.get(e.name, 0) + 1
    return out


def beat_entry(eng, path, beat, wall, prof, **extra):
    s = eng.last_collect_stats
    entry = {"path": path, "beat": beat,
             "graphed": getattr(eng, "graphed", False),
             "scan_path": eng.last_scan_path,
             "join_path": eng.last_join_path,
             "admitted": s["admitted"], "dirty": s["dirty"],
             "wall_ms": wall * 1e3,
             "stage_ms": s["t_stage_s"] * 1e3,
             "dispatch_ms": s["t_dispatch_s"] * 1e3,
             "device_wait_ms": s["t_kernel_s"] * 1e3,
             "collect_ms": s["t_collect_s"] * 1e3,
             "backend_ops": s["backend_ops"], "profiled": prof is not None,
             "fold_in_flight": False, **extra}
    if prof is not None:
        (entry["device_busy_ms"], entry["device_events"],
         entry["top_device_ops"]) = busy_ms(prof)
        entry["host_ops"] = host_ops(prof)
    return entry


def twin_beat(eng, eager, what, launched, eager_launched):
    """The graphed engine's beat against its ``jit=False`` twin's, with
    the same history: the same paths, backend ops and kernel launches."""
    paths = (eng.last_scan_path, eng.last_join_path)
    if (eager.last_scan_path, eager.last_join_path) != paths:
        fail(f"{what}: graphed paths {paths}, eager "
             f"{(eager.last_scan_path, eager.last_join_path)}")
    ops, eops = (e.last_collect_stats["backend_ops"] for e in (eng, eager))
    if ops != eops:
        fail(f"{what}: graphed backend ops {ops}, eager {eops}")
    if launched != eager_launched:
        fail(f"{what}: graphed kernel launches {launched}, eager "
             f"{eager_launched}")


def tickets_identical(a, b, what):
    """Bit for bit, group scores too: the graph replays the eager body's
    kernels on the same inputs (TPC-W's group sums are exact)."""
    import numpy as np
    for k, want in b.result.items():
        got = a.result[k]
        if got.dtype != want.dtype or not np.array_equal(got, want):
            fail(f"{what} {a.template}.{k}: {got[:4]} vs {want[:4]}")


def check_beat(eng, what, tickets, want_paths, want_ops):
    """Every ticket answered, the paths and backend launches expected
    (None: not checked), no overflow."""
    if any(t.result is None for t in tickets):
        fail(f"{what}: a ticket was not answered")
    paths = (eng.last_scan_path, eng.last_join_path)
    if want_paths is not None and paths != want_paths:
        fail(f"{what}: paths {paths}, want {want_paths}")
    ops = eng.last_collect_stats["backend_ops"]
    if want_ops is not None and ops != want_ops:
        fail(f"{what}: backend ops {ops}, want {want_ops}")
    if eng.last_delta_overflow or eng.last_overflow:
        fail(f"{what}: overflow {eng.last_delta_overflow}/"
             f"{eng.last_overflow}")


def check_sample(tickets, base, what, dense=False):
    """A sample of the tickets against the query-at-a-time engine
    (best_sellers only on the dense catalog, as in the reference's
    index-less streams)."""
    picked = [t for t in tickets if dense or t.template != "best_sellers"]
    step = max(1, len(picked) // SAMPLE_PER_BEAT)
    for t in picked[::step][:SAMPLE_PER_BEAT]:
        matches_baseline(t, base.execute(t.template, t.params).result, what)


def _beats(eng, eager, plain, base, scale_i, scale_c, dense):
    queries, updates, steady = workload(scale_i, scale_c)
    catalog = "dense" if dense else "indexless"
    log = []
    # the beats after the reseed are steady; the last of them runs under
    # torch.profiler to read the card's busy time in a steady beat, on
    # the engine under test and on its eager twin
    for beat in range(2 + STEADY_BEATS):
        profiled = beat == 1 + STEADY_BEATS
        ups = updates if beat == 0 else steady[beat - 1]
        qs = slot_stable(queries, beat, scale_c) if beat else list(queries)
        engines = [e for e in (eng, eager, plain) if e is not None]
        tickets = []
        for e in engines:
            for u in ups:
                e.submit_update(*u)
            tickets.append([e.submit(n, p) for n, p in qs])
        if base is not None:
            for u in ups:
                base.apply_update(*u)
        wall, prof, launched = timed_beat(eng, profiled)
        log.append(beat_entry(eng, catalog, beat, wall, prof))
        what = f"{catalog} beat {beat}"
        check_beat(eng, what, tickets[0],
                   (("delta", "" if dense else "delta") if beat else None),
                   FUSED_STEADY if beat else None)
        if plain is None:
            continue
        wall, prof, eager_launched = timed_beat(eager, profiled, aside=True)
        log.append(beat_entry(eager, catalog, beat, wall, prof))
        twin_beat(eng, eager, what, launched, eager_launched)
        for a, b in zip(tickets[0], tickets[1]):
            tickets_identical(a, b, f"{what} graphed vs eager")
        plain.run_until_drained()
        for a, b in zip(tickets[0], tickets[2]):
            tickets_equal(a, b, f"{what} hopper vs torch")
        check_sample(tickets[0], base, what, dense)
    return log


# --------------------------------------- 4b. folding and the chained beat
def buy_request_address():
    """TPC-W's Buy Request page shows the customer's address with its
    country: ``address`` joined to the 92-row ``country`` table, which
    has no dense index on this catalog (a block join)."""
    from repro_torch.core.plan import Join, Pred, QueryTemplate
    return QueryTemplate("buy_request_address", "address",
                         preds=(Pred("address", "addr_id"),),
                         joins=(Join("addr_co_id", "country"),), limit=1)


class SteadyTraffic:
    """The fold and chained paths' steady beats, from SEED: 4 customer
    ``c_expiration`` updates, 4 ``shopping_cart_line`` ``scl_qty`` updates
    (TPC-W Shopping Cart: live probes on the cart -> item join) and 2
    ``address`` ``addr_co_id`` updates (a customer moves country: live
    probes on the block join), on the fixed addresses that the
    ``buy_request_address`` queries ask for."""

    def __init__(self, scale_c):
        import numpy as np
        self.rng = np.random.default_rng(SEED + 1)
        self.scale_c = scale_c
        self.addrs = [int(a) for a in
                      np.sort(self.rng.choice(scale_c, FOLD_CAP, False))]

    def updates(self):
        r = self.rng
        return ([("customer", "update",
                  {"key": int(r.integers(0, self.scale_c)),
                   "col": "c_expiration",
                   "val": int(r.integers(12000, 15000))}) for _ in range(4)]
                + [("shopping_cart_line", "update",
                    {"key": int(r.integers(0, 4096)), "col": "scl_qty",
                     "val": int(r.integers(1, 5))}) for _ in range(4)]
                + [("address", "update",
                    {"key": int(r.choice(self.addrs)), "col": "addr_co_id",
                     "val": int(r.integers(0, 92))}) for _ in range(2)])

    def address_queries(self):
        return [("buy_request_address", {0: (a, a)}) for a in self.addrs]


class Recorder:
    """A pass-through on a backend's ops that keeps copies of their
    inputs while the op's name is in ``armed``."""

    def __init__(self, armed=()):
        self.armed = set(armed)
        self.calls = {}

    def backend(self, base, name, **override):
        import dataclasses
        fields = ("scan", "join_block", "join_partitioned", "groupby",
                  "scan_delta", "join_delta", "fused_delta")

        def wrap(op, opname):
            if op is None:
                return None

            def rec(*args):
                if opname in self.armed:
                    self.calls.setdefault(opname, []).append(
                        clone_tree(args))
                return op(*args)
            return rec
        ops = {f: wrap(getattr(base, f), f) for f in fields}
        ops.update(override)
        return dataclasses.replace(base, name=name, **ops)


def fold_path(dev, scale_i, scale_c, recorder, keep):
    """The fold path: a QueryCycleServer over an index-less hopper engine
    (base plan: the 13 TPC-W templates) registers ``buy_request_address``
    after a reseed and two steady beats, just before the next beat's
    dispatch, and submits its queries at once;
    the fold builds on the server's background thread while steady beats
    keep coming, commits at a beat boundary (the migration beat: a full
    rescan with one block join), then 3 steady beats and 1 profiled.  Its
    twins — ``jit=False`` on the hopper kernels (whose migration beat
    records the bitmask_join call) and ``torch`` — register at the
    migration beat (foreground builds), so all admit the same work on
    every beat.  ``keep`` receives the engine and its eager twin."""
    import numpy as np
    from repro_torch.core import backends as B
    from repro_torch.core import folding
    from repro_torch.core.baseline import QueryAtATimeEngine
    from repro_torch.core.executor import SharedDBEngine
    from repro_torch.serving import QueryCycleServer
    from repro_torch.workloads import tpcw

    B.register_backend(recorder.backend(B.get_backend("hopper"),
                                        "hopper-recorded"))
    # armed for the eager twin's migration beat alone (not for its
    # builds' throwaway full beats on an empty state)
    armed, recorder.armed = recorder.armed, set()
    data = tpcw.generate_data(np.random.default_rng(SEED), scale_i, scale_c)
    plan = tpcw.build_tpcw_plan(scale_i, scale_c, dense_pk_index=False)
    slots = tpcw.DEFAULT_UPDATE_SLOTS
    eng = SharedDBEngine(plan, slots, data, kernels="hopper", device=dev)
    server = QueryCycleServer(eng)                   # background folds
    eager = SharedDBEngine(plan, slots, data, kernels="hopper-recorded",
                           device=dev, jit=False)
    eager_server = QueryCycleServer(eager, background_folds=False)
    twin = SharedDBEngine(plan, slots, data, kernels="torch", device=dev)
    twin_server = QueryCycleServer(twin, background_folds=False)
    keep.update(eng=eng, eager=eager)
    tmpl = buy_request_address()
    base = QueryAtATimeEngine(
        folding.extend_plan(plan, [tmpl], {tmpl.name: FOLD_CAP}), data,
        device=dev)
    queries, updates, _ = workload(scale_i, scale_c)
    traffic = SteadyTraffic(scale_c)
    script, log, fold_tickets = [], [], []
    held, t_reg, m = [], None, None
    beat = 0
    while True:
        folded = m is not None
        post = 0 if not folded else beat - m
        if folded and post > STEADY_BEATS + 1:
            break
        if not folded and t_reg is not None and (
                beat - 3 >= FOLD_MAX_BEATS
                or time.perf_counter() - t_reg > FOLD_MAX_S):
            fail(f"fold: no commit after {beat - 3} beats / "
                 f"{time.perf_counter() - t_reg:.1f} s")
        ups = updates if beat == 0 else traffic.updates()
        qs = slot_stable(queries, beat, scale_c) if beat else list(queries)
        if folded:
            qs += traffic.address_queries()
        for u in ups:
            server.submit_update(*u)
            base.apply_update(*u)
        tickets = [server.submit(n, p) for n, p in qs]
        if beat == 3:
            # the registration arrives just before a beat: the build runs
            # on the server's fold thread while the beats go on
            t_reg = time.perf_counter()
            if server.register_template(tmpl, FOLD_CAP)["status"] != \
                    "folding":
                fail("fold: registration did not start a fold")
            held = [server.submit(n, p)
                    for n, p in traffic.address_queries()]
        in_flight = eng.fold_in_flight()
        ready = eng.fold_ready()
        profiled = folded and post == STEADY_BEATS + 1
        # the beat that commits the fold drains in-flight beats by design:
        # the one dispatch not run under sync-debug "error"
        wall, prof, launched = timed_beat(eng, profiled, exempt=ready)
        committed = not folded and eng.folds_done == 1
        if committed:
            m = beat
            t_commit = time.perf_counter()
            tickets += held
            for s in (eager_server, twin_server):
                if s.register_template(tmpl, FOLD_CAP)["status"] != \
                        "folding":
                    fail("fold: a twin's registration did not fold")
        twin_qs = qs + (traffic.address_queries() if committed else [])
        script.append((ups, twin_qs))
        for s in (eager_server, twin_server):
            for u in ups:
                s.submit_update(*u)
        eager_tickets = [eager_server.submit(n, p) for n, p in twin_qs]
        twin_tickets = [twin_server.submit(n, p) for n, p in twin_qs]
        what = f"fold beat {beat}"
        fold_state = dict(fold_in_flight=(in_flight and not ready
                                          and not committed),
                          migration=committed)
        log.append(beat_entry(eng, "fold", beat, wall, prof, **fold_state))
        recorder.armed = armed if committed else set()
        wall, prof, eager_launched = timed_beat(eager, profiled,
                                                exempt=committed, aside=True)
        recorder.armed = set()
        log.append(beat_entry(eager, "fold", beat, wall, prof, **fold_state))
        twin_beat(eng, eager, what, launched, eager_launched)
        for a, b in zip(tickets, eager_tickets):
            tickets_identical(a, b, f"{what} graphed vs eager")
        twin.run_until_drained()
        if beat == 0 or committed:
            check_beat(eng, what, tickets, ("full", "full"), None)
            if committed and eng.last_collect_stats["backend_ops"].get(
                    "join_block") != 1:
                fail(f"{what}: migration beat ran "
                     f"{eng.last_collect_stats['backend_ops']}")
        else:
            check_beat(eng, what, tickets, ("delta", "delta"), FUSED_STEADY)
        for a, b in zip(tickets, twin_tickets):
            tickets_equal(a, b, f"{what} hopper vs torch")
        check_sample(tickets, base, what)
        if folded or committed:
            fold_tickets.append(tickets)
        beat += 1
    if twin.folds_done != 1 or eager.folds_done != 1:
        fail("fold: a twin did not commit its fold")
    print_capture("fold", eng)
    return {"log": log, "script": script, "migration": m,
            "tickets": fold_tickets,
            "latency_s": t_commit - t_reg,
            "build_s": eng.last_fold_build_s,
            "beats_in_flight": m - 3}


def chained_path(dev, scale_i, scale_c, fold, recorder, keep):
    """The chained path: a cold engine compiled with all 14 templates on
    ``hopper-chained`` (the hopper kernels, fused_delta None) and its twin
    on ``torch`` replay the fold path's beats; from the fold's migration
    beat on, the tickets must equal the folded engine's.  The last
    unprofiled steady beat before the profiled one records its delta_scan /
    delta_join inputs (one grouped call each).  ``keep`` receives the
    engine and its eager twin."""
    import numpy as np
    from repro_torch.core import backends as B
    from repro_torch.core.baseline import QueryAtATimeEngine
    from repro_torch.core.executor import SharedDBEngine
    from repro_torch.core.plan import compile_plan
    from repro_torch.workloads import tpcw

    B.register_backend(recorder.backend(B.get_backend("hopper"),
                                        "hopper-chained", fused_delta=None))
    data = tpcw.generate_data(np.random.default_rng(SEED), scale_i, scale_c)
    catalog = tpcw.make_catalog(scale_i, scale_c, dense_pk_index=False)
    templates, caps = tpcw.make_templates(catalog.schemas["item"].capacity)
    tmpl = buy_request_address()
    plan = compile_plan(catalog, templates + [tmpl],
                        dict(caps, **{tmpl.name: FOLD_CAP}))
    slots = tpcw.DEFAULT_UPDATE_SLOTS
    eng = SharedDBEngine(plan, slots, data, kernels="hopper-chained",
                         device=dev)
    print_capture("chained", eng)
    eager = SharedDBEngine(plan, slots, data, kernels="hopper-chained",
                           device=dev, jit=False)
    keep.update(eng=eng, eager=eager)
    twin = SharedDBEngine(plan, slots, data, kernels="torch", device=dev)
    base = QueryAtATimeEngine(plan, data, device=dev)
    log, m = [], fold["migration"]
    last = len(fold["script"]) - 1
    for beat, (ups, qs) in enumerate(fold["script"]):
        tickets, eager_tickets, twin_tickets = [], [], []
        for e, out in ((eng, tickets), (eager, eager_tickets),
                       (twin, twin_tickets)):
            for u in ups:
                e.submit_update(*u)
            out += [e.submit(n, p) for n, p in qs]
        for u in ups:
            base.apply_update(*u)
        wall, prof, launched = timed_beat(eng, beat == last)
        what = f"chained beat {beat}"
        log.append(beat_entry(eng, "chained", beat, wall, prof))
        # the eager twin's calls are Python calls: the recorder keeps a
        # steady beat's (unprofiled) delta_scan / delta_join inputs
        if beat == last - 1:
            recorder.armed = {"scan_delta", "join_delta"}
        wall, prof, eager_launched = timed_beat(eager, beat == last,
                                                aside=True)
        recorder.armed = set()
        log.append(beat_entry(eager, "chained", beat, wall, prof))
        twin_beat(eng, eager, what, launched, eager_launched)
        for a, b in zip(tickets, eager_tickets):
            tickets_identical(a, b, f"{what} graphed vs eager")
        if beat == 0:
            check_beat(eng, what, tickets, ("full", "full"), None)
        elif beat == m:
            # the first admission of buy_request_address: its 16 slots
            # straddle a word boundary, wider than the address stage's
            # 1-word admission pane, so this beat rescans in full
            check_beat(eng, what, tickets, None, None)
        else:
            check_beat(eng, what, tickets, ("delta", "delta"),
                       CHAINED_STEADY)
        twin.run_until_drained()
        for a, b in zip(tickets, twin_tickets):
            tickets_equal(a, b, f"{what} hopper-chained vs torch")
        if beat >= m:
            for a, b in zip(tickets, fold["tickets"][beat - m]):
                tickets_equal(a, b, f"{what} cold chained vs folded")
        check_sample(tickets, base, what)
    return log


# ------------------------------------------------ 4c. the sharded heartbeat
SHARDED_STEADY = 8          # steady beats after the reseed
SHARDED_S4_BEATS = 4        # beats of the 4-shard engine: reseed + 3
FOLD_BATCH = ("order_lines", "order_display", "get_cart")


def snapshots_identical(a, b, what):
    import numpy as np
    for table in b.plan.catalog.schemas:
        sa, sb = a.snapshot(table), b.snapshot(table)
        for k, v in sb.items():
            if not np.array_equal(np.asarray(sa[k]), np.asarray(v)):
                fail(f"{what}: snapshot {table}.{k} differs")


def query_key(t):
    return t.template, tuple(sorted(t.params.items()))


def sharded_path(dev, scale_i, scale_c, recorder, keep):
    """The sharded path, index-less TPC-W at full scale, every shard on
    this card: engines on row meshes of 1, 2 and 4 shards beside the
    unsharded engine, all graphed, and a ``jit=False`` twin of the 2-shard
    one (on ``hopper-sharded``, the recorder's pass-through: it keeps the
    reseed's scan / join / group-by inputs and a steady beat's fused_delta
    and group-by inputs at shard geometry).  A reseed and SHARDED_STEADY
    slot-stable steady beats (``SteadyTraffic``): the 1-shard engine must
    equal the unsharded one bit for bit (tickets, paths, backend ops,
    launches, every table's snapshot); the 2-shard engine its twin bit for
    bit and the unsharded engine's answers (row sets, scores within rtol
    1e-6), with one all_gather per mirrored predicated stage in the reseed
    and none in a delta beat; the 4-shard engine the unsharded answers
    over SHARDED_S4_BEATS beats.  Beside them a 2-shard engine whose plan
    lacks FOLD_BATCH folds it in through a QueryCycleServer on its
    background thread (registered before beat 3; query-only beats while
    it builds); from its first beat its answers equal the cold 2-shard
    engine's (built with the final set) on the same queries, the folded
    templates' from the migration beat; then ``buy_request_address`` (a
    join into ``country``, which no join probed) must be refused with
    ``fold-mirror-set``.  ``keep`` receives the 2-shard engine and its
    twin for the planlint phase."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.core import backends as B
    from repro_torch.core.executor import SharedDBEngine
    from repro_torch.core.plan import compile_plan
    from repro_torch.core.sharding import make_row_mesh
    from repro_torch.serving import QueryCycleServer
    from repro_torch.workloads import tpcw

    B.register_backend(recorder.backend(B.get_backend("hopper"),
                                        "hopper-sharded"))
    data = tpcw.generate_data(np.random.default_rng(SEED), scale_i, scale_c)
    plan = tpcw.build_tpcw_plan(scale_i, scale_c, dense_pk_index=False)
    catalog = tpcw.make_catalog(scale_i, scale_c, dense_pk_index=False)
    templates, caps = tpcw.make_templates(catalog.schemas["item"].capacity)
    fold_base = compile_plan(
        catalog, [t for t in templates if t.name not in FOLD_BATCH],
        {n: c for n, c in caps.items() if n not in FOLD_BATCH},
        max_results=plan.max_results)
    slots = tpcw.DEFAULT_UPDATE_SLOTS

    def mesh(n):
        return make_row_mesh(n, [dev] * n)
    built = {}
    for name, make in (
            ("unsharded", lambda: SharedDBEngine(plan, slots, data,
                                                 kernels="hopper",
                                                 device=dev)),
            ("S=1", lambda: SharedDBEngine(plan, slots, data,
                                           kernels="hopper", mesh=mesh(1))),
            ("S=2", lambda: SharedDBEngine(plan, slots, data,
                                           kernels="hopper", mesh=mesh(2))),
            ("S=2 eager", lambda: SharedDBEngine(
                plan, slots, data, kernels="hopper-sharded", mesh=mesh(2),
                jit=False)),
            ("S=4", lambda: SharedDBEngine(plan, slots, data,
                                           kernels="hopper", mesh=mesh(4))),
            ("S=2 fold", lambda: SharedDBEngine(fold_base, slots, data,
                                                kernels="hopper",
                                                mesh=mesh(2)))):
        t0 = time.perf_counter()
        built[name] = make()
        print(f"sharded: {name} engine built in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    base, s1, s2, eager, s4, f2 = built.values()
    for name in ("S=1", "S=2", "S=4"):
        print_capture(f"sharded {name}", built[name])
    server = QueryCycleServer(f2)                  # background folds
    keep.update(eng=s2, eager=eager)
    spec = s2._gen.spec
    mi_pred = [st for st in s2._lowered.scans
               if spec.is_mirrored(st.table) and st.cols]
    print(f"sharded: S=2 on {[str(d) for d in spec.devices]}: mirrored "
          f"{list(spec.mirrored)}; rows a shard (Ts / mirror Tp): "
          + json.dumps({t: spec.rows(t) for t in spec.plan.catalog.schemas}))
    queries, updates, _ = workload(scale_i, scale_c)
    traffic = SteadyTraffic(scale_c)
    log, fold = [], {}
    last = SHARDED_STEADY
    for beat in range(1 + SHARDED_STEADY):
        ups = updates if beat == 0 else traffic.updates()
        qs = slot_stable(queries, beat, scale_c) if beat else list(queries)
        engines = [base, s1, s2, eager] + \
            ([s4] if beat < SHARDED_S4_BEATS else [])
        tickets = {}
        for e in engines:
            for u in ups:
                e.submit_update(*u)
            tickets[id(e)] = [e.submit(n, p) for n, p in qs]
        what = f"sharded beat {beat}"
        profiled = beat == last
        steady = None if beat == 0 else {"fused_delta": 2, "groupby": 2}
        paths = ("full", "full") if beat == 0 else ("delta", "delta")

        before = K.COLLECTIVES["all_gather_rows"]
        wall, prof, launched = timed_beat(s2, profiled)
        gathers = K.COLLECTIVES["all_gather_rows"] - before
        log.append(beat_entry(
            s2, "sharded", beat, wall, prof, shards=2, collectives=gathers,
            launches_per_shard={k: n / 2 for k, n in launched.items()}))
        check_beat(s2, what, tickets[id(s2)], paths, steady)
        if gathers != (len(mi_pred) if beat == 0 else 0):
            fail(f"{what}: {gathers} all_gathers, mirrored predicated "
                 f"stages {len(mi_pred)}")
        recorder.armed = ({"scan", "join_partitioned", "groupby"}
                          if beat == 0 else {"fused_delta", "groupby"}
                          if beat == last - 1 else set())
        wall, prof, eager_launched = timed_beat(eager, profiled, aside=True)
        recorder.armed = set()
        log.append(beat_entry(eager, "sharded", beat, wall, prof, shards=2))
        twin_beat(s2, eager, what, launched, eager_launched)
        for a, b in zip(tickets[id(s2)], tickets[id(eager)]):
            tickets_identical(a, b, f"{what} graphed vs eager")

        wall, prof, launched_u = timed_beat(base, profiled)
        log.append(beat_entry(base, "sharded unsharded", beat, wall, prof,
                              shards=0))
        check_beat(base, f"{what} unsharded", tickets[id(base)], paths,
                   None if beat == 0 else FUSED_STEADY)
        for a, b in zip(tickets[id(s2)], tickets[id(base)]):
            matches_baseline(a, b.result, f"{what} S=2 vs unsharded")
        wall, prof, launched_1 = timed_beat(s1, False)
        log.append(beat_entry(s1, "sharded S=1", beat, wall, prof, shards=1))
        twin_beat(s1, base, f"{what} S=1 vs unsharded", launched_1,
                  launched_u)
        for a, b in zip(tickets[id(s1)], tickets[id(base)]):
            tickets_identical(a, b, f"{what} S=1 vs unsharded")
        snapshots_identical(s1, base, f"{what} S=1 vs unsharded")
        if s4 in engines:
            wall, prof, _ = timed_beat(s4, False)
            log.append(beat_entry(s4, "sharded S=4", beat, wall, prof,
                                  shards=4))
            check_beat(s4, f"{what} S=4", tickets[id(s4)], paths,
                       None if beat == 0 else {"fused_delta": 4,
                                               "groupby": 4})
            for a, b in zip(tickets[id(s4)], tickets[id(base)]):
                matches_baseline(a, b.result, f"{what} S=4 vs unsharded")
        fold_beats(server, f2, beat, ups, qs, tickets[id(s2)], fold, log)
    if f2.folds_done != 1:
        fail("sharded fold: no commit")
    print_capture("sharded S=2 fold", f2)
    try:
        server.register_template(buy_request_address(), FOLD_CAP)
        fail("sharded fold: buy_request_address (a join into country) was "
             "not refused under the mesh")
    except ValueError as e:
        if "[planlint:fold-mirror-set]" not in str(e):
            raise
        print(f"sharded fold: buy_request_address refused: {e}")
    return {"log": log, "fold": fold}


def fold_beats(server, f2, beat, ups, qs, cold_tickets, fold, log):
    """One script beat of the sharded fold engine: beats 0-2 and 4- run
    the script beat's updates and its queries of registered templates;
    before beat 3 FOLD_BATCH is registered, and beat 3 runs its updates
    and all its queries (FOLD_BATCH's wait in their queues), then
    query-only beats until the build lands, then the migration beat.
    Every answered ticket must equal the cold engine's on the same
    query of this script beat."""
    want = {query_key(t): t for t in cold_tickets}
    first = True
    if beat == 3:
        templates, caps = tpcw_templates(f2)
        fold["t_reg"] = time.perf_counter()
        for r in server.register_templates(
                [(t, caps[t.name]) for t in templates
                 if t.name in FOLD_BATCH]):
            if r["status"] != "folding":
                fail(f"sharded fold: registration {r['status']}")
        fold["beats_in_flight"] = 0
    while True:
        ready = f2.fold_ready()
        for u in (ups if first else ()):
            server.submit_update(*u)
        mine = [server.submit(n, p) for n, p in qs
                if n in server.registered and (first or n not in FOLD_BATCH)]
        if beat == 3 and first:
            fold["held"] = [t for t in mine if t.template in FOLD_BATCH]
        wall, _, _ = timed_beat(f2, False, exempt=ready)
        committed = "t_commit" not in fold and f2.folds_done == 1
        log.append(beat_entry(f2, "sharded S=2 fold", beat, wall, None,
                              shards=2, migration=committed,
                              fold_in_flight=f2.fold_in_flight()))
        for t in mine:
            if t.result is not None:
                tickets_equal(t, want[query_key(t)],
                              f"sharded fold beat {beat} vs cold S=2")
        if committed:
            fold["t_commit"] = time.perf_counter()
            fold["build_s"] = f2.last_fold_build_s
            if (f2.last_scan_path, f2.last_join_path) != ("full", "full"):
                fail("sharded fold: the migration beat is not a full rescan")
        first = False
        if beat != 3 or "t_commit" in fold:
            break
        fold["beats_in_flight"] += 1
        if time.perf_counter() - fold["t_reg"] > FOLD_MAX_S:
            fail("sharded fold: no commit within "
                 f"{FOLD_MAX_S} s")
        time.sleep(0.005)
    if beat == 3:
        late = [t for t in fold["held"] if t.result is None]
        if late or not fold["held"]:
            fail("sharded fold: the folded templates' queries were not "
                 "answered at the migration beat")
        for t in fold["held"]:
            tickets_equal(t, want[query_key(t)],
                          "sharded fold migration beat vs cold S=2")


def tpcw_templates(eng):
    """TPC-W's templates and slot capacities at the engine's scale."""
    from repro_torch.workloads import tpcw
    return tpcw.make_templates(eng.plan.catalog.schemas["item"].capacity)


def sharded_kernel_check(calls):
    """The sharded path's recorded kernel calls (shard geometry: [Ts]
    spines, per-shard dirty sets, the mirror slices of a reseed), each
    held against its plain version on the same inputs: words, rids and
    counts bit-equal, group sums within rtol 1e-6."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.kernels import (clockscan, fused_delta, partitioned_join,
                                     ref, shared_groupby)
    pairs = {"scan": (clockscan.clockscan, ref.clockscan_ref),
             "join_partitioned": (partitioned_join.partitioned_join,
                                  ref.partitioned_join_ref),
             "groupby": (shared_groupby.shared_groupby,
                         ref.shared_groupby_ref),
             "fused_delta": (fused_delta.fused_delta, ref.fused_delta_ref)}
    out = {}
    with K.recording():
        for op, (kern, plain) in pairs.items():
            recorded = calls.get(op, [])
            if not recorded:
                fail(f"sharded: no recorded {op} call")
            errs, lead_dims = [], set()
            for args in recorded:
                if op == "join_partitioned" and not \
                        partitioned_join.buckets_ordered(args[2], args[3]):
                    fail("sharded partitioned_join: buckets not in "
                         "build_key_partitions' order")
                want = plain(*clone_tree(args))
                got = clone_tree(kern(*clone_tree(args)))
                if op == "groupby":
                    same(got[0], want[0], "shared_groupby counts (sharded)")
                    if not torch.allclose(got[1], want[1], rtol=1e-6):
                        fail("shared_groupby sums (sharded)")
                else:
                    same(got, want, f"{op} (sharded path)")
                errs.append(max_abs_err(got, want))
                lead = args[0][0].cols if op == "fused_delta" else args[0]
                lead_dims.add(tuple(lead.shape))
            out[op] = {"calls": len(recorded), "max_abs_err": max(errs),
                       "first_input_shapes": sorted(lead_dims)}
        torch.cuda.synchronize()
    print("sharded kernel calls against their plain versions:",
          json.dumps(out))


def print_sharded_summary(sharded):
    """Median steady walls of the unsharded, 1-, 2- and 4-shard engines,
    the 2-shard engine's profiled beat beside its eager twin's and the
    unsharded engine's, and the fold's latency."""
    log = sharded["log"]
    print_graphed_beside_eager(
        "steady beat, sharded S=2",
        [e for e in log if e["path"] == "sharded" and e["beat"]])
    print_graphed_beside_eager(
        "steady beat, sharded unsharded (graphed) vs S=2 eager twin",
        [e for e in log if e["beat"] and (
            e["path"] == "sharded unsharded"
            or (e["path"] == "sharded" and not e["graphed"]))])
    for path in ("sharded unsharded", "sharded S=1", "sharded", "sharded S=4",
                 "sharded S=2 fold"):
        walls = [e["wall_ms"] for e in log if e["path"] == path
                 and e["graphed"] and e["beat"] and not e["profiled"]
                 and not e.get("fold_in_flight") and not e.get("migration")]
        reseed = [e["wall_ms"] for e in log if e["path"] == path
                  and e["graphed"] and e["beat"] == 0]
        print(f"{path}: median steady wall "
              f"{statistics.median(walls) if walls else float('nan'):.3f} "
              f"ms over {len(walls)} beats; reseed wall "
              f"{reseed[0] if reseed else float('nan'):.3f} ms")
    fold = sharded["fold"]
    print(f"sharded fold (S=2): begin_fold -> build done "
          f"{fold['build_s'] * 1e3:.1f} ms; registration -> committed "
          f"{(fold['t_commit'] - fold['t_reg']) * 1e3:.1f} ms; "
          f"{fold['beats_in_flight']} query-only beats while in flight")



# --------------------------------------------------------- 4d. planlint
# the fold's registration -> commit before the construction gate, in the
# compiled beat's two change runs as PERF.md §5 records them (NVIDIA H100
# 80GB HBM3, 700.00 W); printed beside this run's
PREVIOUS_FOLD_LATENCY_MS = (3828.2, 3872.0)


def planlint_path(path, kept, card, fold=None):
    """planlint on one SharedDB path after its beats: the construction
    gate's host time per plan generation (the graphed engine's, the fold's
    second generation gated on its fold thread); the kernel passes
    against the fused_delta descriptor that ``launch_schedule`` cached on
    the card for the path's fused_delta launches (looked up by the
    geometry of the installed generation: a cache miss fails), or on a
    path without fused_delta one it builds; the trace passes on the eager
    twin (its bodies re-run on the ``torch`` backend, on clones of its
    buffers); the graphed engine's fixed buffers.  Any error finding
    fails.  Prints ``planlint:`` lines with the card beside every time;
    returns the findings."""
    from repro_torch import kernels as K
    from repro_torch.analysis_static import (errors_in, format_findings,
                                             kernel_passes, trace_passes)
    from repro_torch.kernels import fused_delta as fd
    eng, eager = kept["eng"], kept["eager"]
    t0 = time.perf_counter()
    gates = ", ".join(f"{s * 1e3:.4f}" for s in eng.gate_s)
    print(f"planlint: {path}: construction gate {gates} ms per plan "
          f"generation ({len(eng.gate_s)}) [{card}]")
    if fold is not None:
        print(f"planlint: {path}: registration -> commit "
              f"{fold['latency_s'] * 1e3:.1f} ms with the gate on the fold "
              f"thread, {PREVIOUS_FOLD_LATENCY_MS[0]} / "
              f"{PREVIOUS_FOLD_LATENCY_MS[1]} ms without it (PERF.md §5) "
              f"[{card}]")
    # the device as a tensor names it (its index included): the key the
    # fused_delta wrapper cached its descriptor under; on a mesh, shard
    # 0's, and one shard's fused geometry
    from repro_torch.core import sharding
    spec = eng._gen.spec
    state = eng.state if spec is None else eng.state[0]
    dev = state[next(iter(state))]["_valid"].device
    geom = kernel_passes.geometry_from_lowered(eng._lowered) \
        if spec is None else sharding.fused_geometry(eng._lowered, spec)
    findings = []
    if geom.sgeom or geom.jgeom:
        hits = fd.launch_schedule.cache_info().hits
        desc, n_block = kernel_passes.launch_descriptor(geom, dev)
        cached = fd.launch_schedule.cache_info().hits > hits
        launches = eng._backend.fused_delta is not None
        if launches and not cached:
            fail(f"planlint {path}: the installed generation's fused "
                 "geometry is not one launch_schedule cached on the card")
        findings += kernel_passes.run_kernel_passes(
            geom, desc, n_block, sms=K.sm_count(dev),
            location=f"{path} fused")
        print(f"planlint: {path}: kernel passes on the "
              f"{'cached' if cached else 'built'} descriptor of "
              f"{desc.shape[0]} items ({n_block} block items, "
              f"{len(geom.sgeom)} stages, {len(geom.jgeom)} joins)")
    t1 = time.perf_counter()
    findings += trace_passes.run_trace_passes(eager,
                                              location=f"{path} eager")
    findings += trace_passes.lint_buffer_aliasing(
        eng._gen, eng.state, location=f"{path} graphed")
    t2 = time.perf_counter()
    errs = errors_in(findings)
    notes = [f for f in findings if f.severity != "error"]
    print(f"planlint: {path}: {len(errs)} error finding(s), {len(notes)} "
          f"note(s); trace passes {(t2 - t1) * 1e3:.1f} ms, all passes "
          f"{(t2 - t0) * 1e3:.1f} ms [{card}]")
    for f in notes:
        print("planlint: note:", f.format())
    if errs:
        fail(f"planlint {path}:\n{format_findings(errs)}")
    return findings


def planlint_recorded(calls, card):
    """The kernel passes on each recorded fused_delta call: its geometry
    as the wrapper computes it, the descriptor ``launch_schedule`` cached
    for it on the card (a miss fails), and the call's own dirty rows for
    the one-writer replay."""
    from repro_torch import kernels as K
    from repro_torch.analysis_static import (errors_in, format_findings,
                                             kernel_passes)
    from repro_torch.kernels import fused_delta as fd
    for i, (scan_in, join_in) in enumerate(calls):
        dev = scan_in[0].cols.device
        geom = kernel_passes.geometry_from_inputs(scan_in, join_in)
        hits = fd.launch_schedule.cache_info().hits
        desc, n_block = kernel_passes.launch_descriptor(geom, dev)
        if fd.launch_schedule.cache_info().hits == hits:
            fail(f"planlint: recorded fused_delta call {i}: its descriptor "
                 "is not one launch_schedule cached on the card")
        rows = tuple(e.rows.cpu().numpy() for e in join_in)
        errs = errors_in(kernel_passes.run_kernel_passes(
            geom, desc, n_block, sms=K.sm_count(dev), dirty_rows=rows,
            location=f"recorded fused_delta {i}"))
        if errs:
            fail(f"planlint:\n{format_findings(errs)}")
    print(f"planlint: {len(calls)} recorded fused_delta call(s): kernel "
          f"passes clean on the card's cached descriptors [{card}]")


def planlint_phase(kept, fold, card):
    """planlint on the five SharedDB paths (``planlint_path``; on the
    sharded one the collective rules too) and the hot-path source
    pass."""
    from repro_torch.analysis_static import errors_in, source_passes
    for path in ("dense", "indexless", "fold", "chained", "sharded"):
        planlint_path(path, kept[path], card,
                      fold if path == "fold" else None)
    errs = errors_in(source_passes.lint_hot_path_asserts())
    if errs:
        fail(f"planlint: bare asserts on the hot path: {errs}")
    print(f"planlint: source pass clean over "
          f"{len(source_passes.HOT_PATH_MODULES)} hot-path modules")


# ------------------------------------ 4e. the SLA model and the roofline
SLA_SECONDS = 3.0          # TPC-W's tightest interaction timeout (3-10 s)


def sla_phase(kept, log, card, scale_i, scale_c):
    """``sla:`` lines, for the dense, index-less and 2-shard engines: the
    paper's worst-case cycle (``core/sla.cycle_cost`` under the H100
    ``HwModel``) and ``provision(plan, SLA_SECONDS)``, beside the path's
    measured reseed (its beat 0, unprofiled) and one more reseed of the
    graphed engine, forced (``_force_full``) and run under torch.profiler:
    its wall and the card's busy time, each over the model's worst cycle.
    ``roofline:`` lines: ``fused_delta_footprint`` of each engine's
    steady beat (shards 2 on the sharded one: its terms assume a card a
    shard), and ``collective_schedule`` of the 2-shard reseed as
    planlint's recorder sees it (its ``all_gather_rows`` and their output
    bytes).  Runs after the planlint phase; the forced beats count in no
    path's launches.  Returns the footprints by path."""
    from repro_torch.analysis_static import trace_passes
    from repro_torch.core import sla
    from repro_torch.roofline import (HW, collective_schedule,
                                      fused_delta_footprint)
    hw = sla.HwModel()
    print(f"sla: HwModel flops_per_s {hw.flops_per_s:.6e} (int32 on the "
          f"CUDA cores), bytes_per_s {hw.bytes_per_s:.6e} [{card}]")
    queries = workload(scale_i, scale_c)[0]
    out = {}
    for path, shards in (("dense", 1), ("indexless", 1), ("sharded", 2)):
        eng = kept[path]["eng"]
        plan = eng._lowered.plan
        cost = sla.cycle_cost(plan, hw)
        prov = sla.provision(plan, SLA_SECONDS, hw)
        model_ms = cost["worst_cycle_s"] * 1e3
        reseed = next(e["wall_ms"] for e in log if e["path"] == path
                      and e["graphed"] and e["beat"] == 0)
        eng._force_full = True
        tickets = [eng.submit(n, prm) for n, prm in queries]
        wall, prof, _ = timed_beat(eng, True)
        check_beat(eng, f"sla {path} forced reseed", tickets,
                   ("full", "full" if path != "dense" else ""), None)
        busy = busy_ms(prof)[0]
        print(f"sla: {path}: model worst cycle {model_ms:.6f} ms "
              f"({cost['total_flops']:.6e} int ops, "
              f"{cost['total_bytes']:.6e} bytes over {len(cost['nodes'])} "
              f"nodes); provision({SLA_SECONDS} s): "
              f"{prov['chips_required']} card(s), cycle budget "
              f"{prov['cycle_budget_s']} s; measured: reseed wall "
              f"{reseed:.3f} ms (beat 0), forced reseed {wall * 1e3:.3f} ms "
              f"wall under the profiler, card busy {busy:.3f} ms; reseed "
              f"wall / model {reseed / model_ms:.3f}, busy / model "
              f"{busy / model_ms:.3f} [{card}]")
        fp = fused_delta_footprint(eng._lowered, shards)
        out[path] = fp
        print(f"roofline: {path}: fused_delta_footprint (shards {shards}, "
              f"worst case): {fp['bytes']:.6e} bytes, {fp['int_ops']:.6e} "
              f"int ops, {len(fp['per_stage'])} stages, bound "
              f"{fp['step_time_s'] * 1e3:.6f} ms by {fp['dominant']} "
              f"(a card a shard)")
    rec = trace_passes.record_beats(kept["sharded"]["eager"])["full"]
    sched = collective_schedule(rec.collective_bytes, 2)
    print(f"roofline: sharded S=2 reseed collectives (planlint's recorder): "
          f"{json.dumps(sched)}; {sched['total_link_traffic']:.6e} bytes a "
          f"link would take "
          f"{sched['total_link_traffic'] / HW['nvlink_bw'] * 1e3:.6f} ms at "
          f"NVLink's {HW['nvlink_bw']:.3e} B/s (both shards are on this one "
          f"card: no link is crossed) [{card}]")
    if sched["counts"] != {"all-gather": 3}:
        fail(f"roofline: S=2 reseed collectives {sched['counts']}, not 3 "
             f"all-gathers")
    return out


# ------------------------------------------------------- 4f. LM serving
# (arch, depth cut or None, capacity, max_seq, prefill_len, requests,
#  prompt lengths [lo, hi], new tokens)
LM_PATHS = {
    "lm-yi-6b": ("yi-6b", None, 8, 1024, 512, 16, (64, 512), 32),
    "lm-gemma3-27b": ("gemma3-27b", 7, 4, 4096, 2048, 4, (256, 2048), 16),
    "lm-qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", None, 8, 1024, 512, 16,
                           (64, 512), 32),
    "lm-recurrentgemma-2b": ("recurrentgemma-2b", None, 8, 1024, 512, 16,
                             (64, 512), 32),
    "lm-mamba2-370m": ("mamba2-370m", None, 8, 1024, 512, 16, (64, 512),
                       32),
    # 192 decoder tokens hear 1536 zero frames (whisper's 30 s of audio
    # are 1500); max_seq 448 is whisper's decoder context
    "lm-whisper-small": ("whisper-small", None, 8, 448, 192, 16, (16, 192),
                         32),
    # depth cut 100 -> 20 layers (4 groups of 4 self + 1 cross): the
    # whole model is 181 GB in bf16, the cut one 40 GB
    "lm-llama-3.2-vision-90b": ("llama-3.2-vision-90b", 20, 4, 1024, 512,
                                8, (64, 512), 16),
}
# every prefill layer of the server under test, re-run with the plain
# attention from the server's own input to that layer: max |kernel path -
# plain path| <= LM_REL_TOL * max |plain path|, outputs and K/V; of a MoE
# layer, the residual after the attention (the input of its MoE block);
# a recurrent or SSD layer (no kernel) bit-equal
LM_REL_TOL = 2e-2
LM_PROFILED_BEAT = 1       # an admission beat after the first
# the decode-only beats of these paths: the graphed step's logits against
# an eager run of the same step from the cache as it stood before the
# step, relative to the logits' largest magnitude
LM_EAGER_PATHS = ("lm-yi-6b", "lm-qwen2-moe-a2.7b", "lm-recurrentgemma-2b",
                  "lm-mamba2-370m", "lm-whisper-small",
                  "lm-llama-3.2-vision-90b")
LM_EAGER_REL_TOL = 1e-3


class StepRecorder:
    """Keeps what a CycleServer's prefills return until ``take`` hands
    them over, with a copy of the beat's decode logits (the server's
    fixed logits buffer, which a graphed step writes)."""

    def __init__(self, srv):
        # the logits buffer, not the server: the server holds this
        # recorder through its prefill, and a cycle would keep the
        # server's weights alive past its path
        self.logits, self.prefills = srv._logits, []
        prefill = srv._prefill

        def rec_prefill(*a):
            out = prefill(*a)
            self.prefills.append(out)
            return out
        srv._prefill = rec_prefill

    def take(self):
        out = self.prefills, [self.logits.clone()]
        self.prefills = []
        return out


def clone_cache(cache):
    return {k: {f: t.clone() for f, t in e.items()} for k, e in
            cache.items()}


def eager_step_check(srv, before, what):
    """The decode step that the graph just replayed, run again eagerly on
    ``before`` (a copy of the cache taken before the step: a recurrent
    layer's state moves on with every step) with the same token and
    position buffers: greedy tokens equal, logits within LM_EAGER_REL_TOL
    of scale.  Returns the relative error."""
    import torch
    want, _ = srv._decode(srv.params, before, srv._tokens, srv._positions)
    got = srv._logits
    if not torch.equal(got.argmax(-1), want.argmax(-1)):
        fail(f"{what}: graphed decode's greedy tokens "
             f"{got.argmax(-1).tolist()} vs eager "
             f"{want.argmax(-1).tolist()}")
    err = rel_err(got, want)
    if err > LM_EAGER_REL_TOL:
        fail(f"{what}: graphed decode's logits {err} of scale from the "
             f"eager step's, over {LM_EAGER_REL_TOL}")
    return err


class LayerRecorder:
    """While armed, keeps every prefill sublayer's arguments and result
    (``transformer._sublayer_train``) and, of a MoE sublayer, its MoE
    block's input and output (``transformer._apply_mlp_part``), so that
    each layer can be re-run with the plain attention from the same
    input."""

    def __init__(self):
        from repro_torch.models import transformer
        self.tf = transformer
        self.orig = transformer._sublayer_train
        self.orig_mlp = transformer._apply_mlp_part
        self.calls, self.mlp = [], None

    def __enter__(self):
        def rec(*args):
            self.mlp = None
            out = self.orig(*args)
            # (p, spec, x, cfg, positions, ctx, cache_capacity): the
            # arguments before ``kernels`` (and the unsharded axes)
            self.calls.append((args[:7], out, self.mlp))
            return out

        def rec_mlp(p, spec, x, cfg, *axes):
            out = self.orig_mlp(p, spec, x, cfg, *axes)
            if spec.moe:
                self.mlp = (x, out[0])
            return out
        self.tf._sublayer_train = rec
        self.tf._apply_mlp_part = rec_mlp
        return self

    def __exit__(self, *exc):
        self.tf._sublayer_train = self.orig
        self.tf._apply_mlp_part = self.orig_mlp

    def replay_plain(self, what):
        """Each recorded layer re-run with kernels="torch" from its own
        input.  A dense layer: its output against the re-run's (its K/V
        come before its attention, so only the output can differ).  A MoE
        layer: the residual after the attention and the K/V against the
        re-run's; then its MoE block re-run from the server's own
        residual must give the server's output bit for bit (same code,
        same input), and the tokens that the plain-attention residual
        routes to another expert set are counted (a bf16 difference can
        flip a near-tie route, and move a token by a whole expert's
        output: information, not a gate).  A recurrent or SSD layer runs
        no kernel: its re-run must equal its output bit for bit.  Returns
        (the largest relative error, the layer count, tokens routed
        otherwise, tokens routed)."""
        import torch
        from repro_torch.models import moe
        from repro_torch.models.common import apply_norm
        worst, flips, routed = 0.0, 0, 0
        for args, (x, _, entry), mlp in self.calls:
            p, spec, cfg = args[0], args[1], args[3]
            if not spec.moe:
                x2, _, _ = self.orig(*args, "torch")
                if spec.kind in ("rec", "ssm") and not torch.equal(x, x2):
                    fail(f"{what}: a {spec.kind} layer re-run from the "
                         f"server's own input differs from the server's "
                         f"output (max abs {max_abs_err(x, x2)})")
                worst = max(worst, rel_err(x, x2))
                continue
            r, y = mlp
            r2, entry2 = self.tf._sublayer_attn(*args, "torch")
            worst = max(worst, rel_err(r, r2), rel_err(entry["k"],
                                                       entry2["k"]),
                        rel_err(entry["v"], entry2["v"]))
            again, _ = self.orig_mlp(p, spec, r, cfg)
            if not torch.equal(again, y):
                fail(f"{what}: a MoE block re-run from the server's own "
                     f"input differs from the server's output (max abs "
                     f"{max_abs_err(again, y)})")
            sets = []
            for res in (r, r2):
                h = apply_norm(res, p["mlp_norm"], cfg.norm)
                _, _, e = moe.route(p["mlp"], h.reshape(-1, h.shape[-1]),
                                    cfg.moe)
                sets.append(torch.sort(e, dim=-1).values)
            flips += int((sets[0] != sets[1]).any(dim=-1).sum())
            routed += sets[0].shape[0]
        n = len(self.calls)
        self.calls = []
        return worst, n, flips, routed


def count_params(tree):
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return tree.numel()


def rel_err(a, b):
    """max |a - b| / max |b| over two tensors (0 for two zero tensors)."""
    d = (a.float() - b.float()).abs().max()
    scale = b.float().abs().max()
    return float(d / scale) if float(scale) > 0 else float(d)


def layer_divergence(c1, c2):
    """Relative error of each layer's cached K (a recurrent layer's h, an
    SSD layer's state) between two prefills, in layer order (group
    layers, then leftovers)."""
    def field(entry):
        return next(f for f in ("k", "h", "state") if f in entry)
    out = []
    for key in sorted(k for k in c1 if k.startswith("g")):
        f = field(c1[key])
        for layer in range(c1[key][f].shape[0]):
            out.append(rel_err(c1[key][f][layer], c2[key][f][layer]))
    return out + [rel_err(c1[k][field(c1[k])], c2[k][field(c1[k])])
                  for k in sorted(k for k in c1 if k.startswith("x"))]


def lm_path(dev, name, recorded):
    """One LM path: the CycleServer under test (hopper) and a twin on the
    same weights whose prefill attention is the plain version (torch),
    beat for beat, to drain.  Every prefill layer of the server under
    test is re-run with the plain attention from its own input (the gate,
    LM_REL_TOL; a MoE layer's block also re-run from the server's own
    residual, bit-equal: ``LayerRecorder.replay_plain``).  The twin gates
    nothing: it only measures how far the two diverge end to end.  On the
    LM_EAGER_PATHS every decode-only beat's graphed step is held to its
    eager re-run.  Returns the beat log and the path's summary;
    per (causal, window, Sq, Sk), ``recorded[name]`` gets the path's count
    of flash-attention calls and the first such call of the profiled
    beat."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.serving import CycleServer

    arch, depth, cap, max_seq, plen, n_req, (lo, hi), new = LM_PATHS[name]
    cfg = get_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    # prefill sublayers an admission runs (an encoder's too), and those of
    # them that attend (attention, cross): one flash launch each
    specs = [s for prog in (transformer.build_program(cfg),) + ((
        transformer.build_encoder_program(cfg),) if cfg.enc_dec else ())
        for s in prog.group * prog.n_groups + prog.leftover]
    attending = sum(s.kind in ("attn", "cross") for s in specs)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = CycleServer(cfg, capacity=cap, max_seq=max_seq, prefill_len=plen,
                      prefill_budget=2, seed=SEED, device=dev,
                      kernels="hopper")
    if not srv.graphed:
        fail(f"{name}: the server under test does not run graphed")
    st = srv.capture_stats
    print(f"capture, {name} decode step: capture {st['capture_s']:.3f} s, "
          f"graph pool {st['pool_bytes'] / 2 ** 20:.1f} MiB")
    # the twin runs its decode step eagerly: its decode-only beats are
    # the eager walls beside the graphed ones
    twin = CycleServer(cfg, capacity=cap, max_seq=max_seq, prefill_len=plen,
                       prefill_budget=2, params=srv.params, device=dev,
                       kernels="torch", jit=False)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rec, twin_rec, layers = StepRecorder(srv), StepRecorder(twin), \
        LayerRecorder()
    rng = np.random.default_rng(SEED)
    lens = rng.integers(lo, hi + 1, n_req)
    lens[-1] = hi                              # one full-length prompt
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in lens]
    reqs = [srv.submit(p, max_new_tokens=new) for p in prompts]
    for p in prompts:
        twin.submit(p, max_new_tokens=new)
    plain_fa = fa.flash_attention
    mine = recorded.setdefault(name, {})
    log, admissions, beat, n_layer_checks, worst = [], 0, 0, 0, 0.0
    route_flips, routed = 0, 0
    twin_err = {"logits": 0.0, "cache": 0.0}
    eager_checks, eager_err = 0, 0.0
    divergence, decode_profiled = None, False
    # the server's own clock: its beats' walls (the two profiled ones
    # included), without the twin's beats and the checks between them; a
    # request's first token comes at the end of the beat that admits it
    # (all are submitted at the start)
    own_s, first_token_s = 0.0, {}
    while srv.pending() or srv.active():
        # the profiled admission beat, then the first decode-only beat
        # after it (no queue, or every slot taken)
        decode_only = not srv.pending() or srv.active() == cap
        profiled = beat == LM_PROFILED_BEAT or (
            beat > LM_PROFILED_BEAT and decode_only and not decode_profiled)
        decode_profiled |= profiled and beat > LM_PROFILED_BEAT
        def recording(q, k, v, _keep=beat == LM_PROFILED_BEAT, **kw):
            call = mine.setdefault((kw["causal"], kw["window"], q.shape[1],
                                    k.shape[1]), {"launches": 0})
            call["launches"] += 1
            if _keep and "q" not in call:
                call.update(q=q.clone(), k=k.clone(), v=v.clone(), **kw)
            return plain_fa(q, k, v, **kw)
        fa.flash_attention = recording
        before = clone_cache(srv.cache) \
            if name in LM_EAGER_PATHS and decode_only else None
        torch.cuda.synchronize()
        prof = beat_profiler() if profiled else contextlib.nullcontext()
        try:
            with prof, layers:
                t0 = time.perf_counter()
                srv.dispatch()
                active = srv.active()
                srv.collect()
                wall = time.perf_counter() - t0
        finally:
            fa.flash_attention = plain_fa
        admitted = srv.last_admitted
        own_s += wall
        for r in reqs:
            if r.first_token_time is not None and r.id not in first_token_s:
                first_token_s[r.id] = own_s
        entry = {"path": name, "beat": beat, "graphed": True,
                 "admitted": admitted, "active": active,
                 "wall_ms": wall * 1e3,
                 "prefill_ms": srv.last_admit_s * 1e3,
                 "decode_ms": srv.last_decode_s * 1e3,
                 "tokens": admitted + active,
                 "tok_per_s": (admitted + active) / wall,
                 "profiled": profiled}
        if profiled:
            (entry["device_busy_ms"], entry["device_events"],
             entry["top_device_ops"]) = busy_ms(prof)
            entry["host_ops"] = host_ops(prof)
        log.append(entry)
        what = f"{name} beat {beat}"
        w, n, flips, r = layers.replay_plain(what)
        route_flips, routed = route_flips + flips, routed + r
        n_layer_checks += n
        if n != len(specs) * admitted:
            fail(f"{what}: {n} prefill layers recorded for {admitted} "
                 f"admissions")
        worst = max(worst, w)
        if w > LM_REL_TOL:
            fail(f"{what}: prefill layer outputs vs their plain re-run "
                 f"{w} > {LM_REL_TOL} of scale")
        if before is not None and admitted == 0:
            eager_err = max(eager_err, eager_step_check(srv, before, what))
            eager_checks += 1
        before = None
        # the twin's beat, timed (and profiled) like the server's; it
        # admits the same requests on the same beats: the schedule does
        # not depend on the logits (no EOS, fixed lengths)
        torch.cuda.synchronize()
        prof = beat_profiler() if profiled else contextlib.nullcontext()
        with prof:
            t0 = time.perf_counter()
            twin.dispatch()
            twin_active = twin.active()
            twin.collect()
            wall = time.perf_counter() - t0
        entry = {"path": name, "beat": beat, "graphed": False,
                 "admitted": twin.last_admitted, "active": twin_active,
                 "wall_ms": wall * 1e3, "profiled": profiled}
        if profiled:
            (entry["device_busy_ms"], entry["device_events"],
             entry["top_device_ops"]) = busy_ms(prof)
            entry["host_ops"] = host_ops(prof)
        log.append(entry)
        (pre, dec), (tpre, _) = rec.take(), twin_rec.take()
        for (lg, c1), (tlg, tc1) in zip(pre, tpre):
            if not torch.isfinite(lg).all():
                fail(f"{what}: non-finite prefill logits")
            twin_err["logits"] = max(twin_err["logits"], rel_err(lg, tlg))
            div = layer_divergence(c1, tc1)
            twin_err["cache"] = max(twin_err["cache"], max(div))
            if divergence is None:
                divergence = div
        if any(not torch.isfinite(x).all() for x in dec):
            fail(f"{what}: non-finite decode logits")
        admissions += admitted
        beat += 1
    if K.LAUNCHES["flash_attention"] != attending * admissions:
        fail(f"{name}: {K.LAUNCHES['flash_attention']} flash_attention "
             f"launches for {admissions} admissions of {attending} "
             f"attending layers")
    if K.FLASH_ROUTE_LAUNCHES["wgmma"] != attending * admissions:
        fail(f"{name}: the tensor-core flash_attention kernel launched "
             f"{K.FLASH_ROUTE_LAUNCHES['wgmma']} times for {admissions} "
             f"admissions of {attending} attending layers")
    if name in LM_EAGER_PATHS and not eager_checks:
        fail(f"{name}: no decode-only beat held to the eager step")
    for r in reqs:
        if len(r.output) != new or r.truncated or r.done_time is None:
            fail(f"{name}: request {r.id} ended with {len(r.output)} tokens "
                 f"(truncated={r.truncated})")
    tokens = sum(len(r.output) for r in reqs)
    summary = {"path": name, "arch": arch, "layers": cfg.n_layers,
               "prefill_sublayers": len(specs),
               "attending_sublayers": attending,
               "params": count_params(srv.params), "init_s": init_s,
               "admissions": admissions, "beats": beat,
               "beats_s": own_s, "tokens": tokens,
               "tok_per_s": tokens / own_s,
               "first_token_ms_p50": 1e3 * statistics.median(
                   first_token_s.values()),
               "first_token_ms_max": 1e3 * max(first_token_s.values()),
               "layer_checks": n_layer_checks,
               "decode_only_beats_vs_eager_step": eager_checks,
               "max_rel_err_graphed_vs_eager_step": eager_err,
               "max_rel_err_layer_out": worst,
               "twin_end_to_end_rel_err_logits": twin_err["logits"],
               "twin_end_to_end_rel_err_cache": twin_err["cache"],
               "twin_first_admission_k_rel_err_by_layer": divergence,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
               "roofline": lm_model_flops(cfg, cap, plen, log)}
    if cfg.moe is not None:
        summary["moe_tokens_routed_otherwise_by_plain_attention"] = \
            route_flips
        summary["moe_tokens_routed"] = routed
    print(f"{name}: peak memory {summary['peak_mem_gb']:.3f} GiB "
          f"(torch.cuda.max_memory_allocated over the path)")
    return log, summary


def lm_model_flops(cfg, capacity, prefill_len, log):
    """``roofline.model_flops`` of the graphed server's profiled admission
    beat (its prefills at ``prefill_len`` and one decode step of every
    slot) and of its profiled decode-only beat, beside the beat's card
    busy time: the share of the bf16 tensor-core peak that busy time
    would give (information)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.roofline import model_flops
    decode = model_flops(cfg, ShapeSpec("decode", 1, capacity, "decode"))
    out = {}
    for e in log:
        if not (e["graphed"] and e["profiled"]) or not e["device_events"]:
            continue
        kind = "admission" if e["admitted"] else "decode-only"
        # an enc-dec model's prefill shape counts the frames it hears
        seq = prefill_len * (cfg.dec_ratio if cfg.enc_dec else 1)
        flops = decode + (model_flops(cfg, ShapeSpec(
            "prefill", seq, e["admitted"], "prefill"))
            if e["admitted"] else 0.0)
        out[kind] = {"beat": e["beat"], "admitted": e["admitted"],
                     "model_flops": flops,
                     "card_busy_ms": e["device_busy_ms"],
                     "share_of_bf16_peak": flops / (
                         e["device_busy_ms"] / 1e3
                         * TENSOR_CORE_BF16_FLOPS)}
    return out


# ------------------------------------------------------- 4b. the train phase
# the launcher's default arch at full width and depth, at the reference's
# train_4k sequence; batch 2, twice one chip's share of train_4k's 256
# sequences over its 256 chips
TRAIN_STABLELM = ("--arch", "stablelm-1.6b", "--seq", "4096", "--batch", "2",
                  "--steps", "8", "--lr", "3e-3")
# the reference's own resume test and example arch, at full width and
# depth: 4096 tokens are 16 SSD chunks of 256
TRAIN_RESTART = ("--arch", "mamba2-370m", "--seq", "4096", "--batch", "2",
                 "--steps", "10", "--lr", "3e-3")
TRAIN_SAVE_EVERY, TRAIN_FAIL_AT = 4, 6
TRAIN_SMOKE_LOSS_RTOL = 1e-5     # card step vs CPU step, float32
TRAIN_SMOKE_LEAF_TOL = 1e-4      # of each updated leaf's norm
EXAMPLES = ("torch_quickstart.py", "torch_tpcw_serving.py",
            "torch_serve_lm.py", "torch_train_lm.py")


TRAIN_LAUNCHES = {}               # training path -> its launch counts


def zero_launch_path(name, fn):
    """Run ``fn`` with every launch count set to 0 just before and read
    just after: a training path must launch no hand-written kernel."""
    from repro_torch import kernels as K
    K.reset_launches()
    out = fn()
    got, routes = dict(K.LAUNCHES), dict(K.FLASH_ROUTE_LAUNCHES)
    TRAIN_LAUNCHES[name] = got
    print(f"launches, {name} path:", json.dumps(got),
          "flash_attention by route:", json.dumps(routes))
    if any(got.values()) or any(routes.values()):
        fail(f"{name}: a hand-written kernel launched on the training path "
             f"({got}, {routes})")
    return out


def train_stablelm(dev, card):
    """8 steps of the launcher's flow (``launch/train.run``, what
    ``main`` runs) on stablelm-1.6b at full width and depth: every loss
    finite and the last below the first, gnorm finite, the optimizer at
    step 8; the median step (steps 2-8), tokens/s, peak memory, one more
    step under the profiler for the card's busy share, and model FLOPs
    (6 N tokens) as a share of the bf16 peak."""
    import torch
    from repro_torch.configs import ShapeSpec
    from repro_torch.core import pytree
    from repro_torch.launch import train
    from repro_torch.roofline import model_flops
    tr = train.Trainer(train.parse_args(list(TRAIN_STABLELM)))
    if tr.device != dev:
        fail(f"the trainer runs on {tr.device}, not {dev}")
    step_fn, times = tr.step_fn, []

    def timed(state, step):       # float(loss) in the step waits for it
        t0 = time.perf_counter()
        out = step_fn(state, step)
        times.append(time.perf_counter() - t0)
        return out
    tr.step_fn = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, log = train.run(tr)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [m["loss"] for m in log]
    gnorms = [m["gnorm"] for m in log]
    if len(log) != 8 or not all(map(math.isfinite, losses + gnorms)):
        fail(f"stablelm train: losses {losses}, gnorms {gnorms}")
    if not losses[-1] < losses[0]:
        fail(f"stablelm train: the loss did not fall: {losses}")
    if int(state[1]["step"]) != 8:
        fail(f"stablelm train: the optimizer's step is "
             f"{int(state[1]['step'])}, not 8")
    step_ms = statistics.median(times[1:8]) * 1e3
    B, S = tr.args.batch, tr.args.seq
    with train.deterministic():
        torch.cuda.synchronize()
        with beat_profiler() as prof:
            t0 = time.perf_counter()
            state, _ = tr.step_fn(state, 8)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
    busy, events, top = busy_ms(prof)
    flops = model_flops(tr.cfg, ShapeSpec("train", S, B, "train"))
    out = {"path": "lm-train-stablelm-1.6b", "arch": tr.cfg.name,
           "params": sum(p.numel() for p in pytree.leaves(state[0])),
           "batch": B, "seq": S, "losses": losses, "gnorms": gnorms,
           "step_ms": [t * 1e3 for t in times],
           "median_step_ms_2_8": step_ms,
           "tokens_per_s": B * S / (step_ms / 1e3),
           "peak_gib": peak, "profiled_step_wall_ms": prof_ms,
           "card_busy_ms": busy if events else None,
           "device_ops": events,
           "busy_share": busy / prof_ms if events else None,
           "idle_share": 1 - busy / prof_ms if events else None,
           "top_device_ops": top, "model_flops": flops,
           "share_of_bf16_peak": flops / (step_ms / 1e3
                                          * TENSOR_CORE_BF16_FLOPS)}
    c = tr.cfg
    print(f"train: {c.name} ({c.n_layers} layers, d {c.d_model}, "
          f"{c.n_heads}/{c.n_kv} heads, FFN {c.d_ff}, vocab {c.vocab}, "
          f"{out['params'] / 1e9:.3f} B parameters, bf16, float32 moments)"
          f" at batch {B} x seq {S}: losses {losses}; median step (steps "
          f"2-8) {step_ms:.3f} ms, {out['tokens_per_s']:.1f} tokens/s, "
          f"peak memory {peak:.3f} GiB; profiled step {prof_ms:.3f} ms "
          f"wall, card busy "
          + (f"{busy:.3f} ms in {events} device ops (busy share "
             f"{out['busy_share']:.3f}, idle share {out['idle_share']:.3f})"
             if events else "not measured (no device event traced)")
          + f"; model FLOPs a step {flops:.6e} (6 N tokens) = "
          f"{out['share_of_bf16_peak']:.6f} of the bf16 peak "
          f"({TENSOR_CORE_BF16_FLOPS:.3e} FLOP/s) at the median step "
          f"[{card}]")
    print("train: stablelm-1.6b top device ops of the profiled step:",
          json.dumps(top))
    return out


def train_smoke_parity(dev):
    """One float32 train_step of smoke-size stablelm on the card against
    the same step on the CPU (the port, plain path, same tree and
    batch): loss within TRAIN_SMOKE_LOSS_RTOL relative, every updated
    parameter and moment within TRAIN_SMOKE_LEAF_TOL of its norm."""
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.core import pytree
    from repro_torch.launch import train
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_model
    cfg = smoke_config("stablelm-1.6b")
    base = transformer.init_lm(torch.Generator().manual_seed(SEED), cfg,
                               "cpu", torch.float32)
    tr = train.Trainer(train.parse_args(
        ["--arch", "stablelm-1.6b", "--smoke", "--seq", "64", "--batch",
         "4", "--device", "cpu"]))
    batch = tr.batch(0)
    out = {}
    for where in ("cpu", dev):
        api = get_model(cfg, device=where)
        params = pytree.tree_map(lambda t: t.to(where, copy=True), base)
        opt = api.init_opt(params)
        loss, params, opt, gnorm = api.train_step(
            params, opt, {k: v.to(where) for k, v in batch.items()})
        out[str(where)] = (float(loss), float(gnorm), pytree.tree_map(
            lambda t: t.cpu(), (params, opt["m"], opt["v"])))
    (l0, n0, t0), (l1, n1, t1) = out["cpu"], out[str(dev)]
    if abs(l1 - l0) > TRAIN_SMOKE_LOSS_RTOL * abs(l0):
        fail(f"smoke train_step: card loss {l1} vs CPU {l0}")
    worst = 0.0
    for a, b in zip(pytree.leaves(t1), pytree.leaves(t0)):
        err = float(torch.linalg.vector_norm((a - b).double()))
        ref = float(torch.linalg.vector_norm(b.double()))
        if err > TRAIN_SMOKE_LEAF_TOL * ref:
            fail(f"smoke train_step: a leaf differs by {err} (norm {ref})")
        worst = max(worst, err / ref if ref else 0.0)
    print(f"train: smoke stablelm-1.6b float32 train_step, card vs CPU: "
          f"loss {l1!r} vs {l0!r}, gnorm {n1!r} vs {n0!r}, worst leaf "
          f"{worst:.3e} of its norm (tolerances {TRAIN_SMOKE_LOSS_RTOL} "
          f"relative, {TRAIN_SMOKE_LEAF_TOL} of the norm)")
    return {"loss_card": l1, "loss_cpu": l0, "worst_leaf_rel": worst}


def train_restart(dev, card):
    """mamba2-370m at full width and depth through the launcher's
    FaultTolerantLoop (checkpoints every 4 steps in a temp dir, removed
    after) with a fault injected at step 6: the replayed steps 4-5 give
    the first pass's losses bit for bit, and the final state equals an
    uninterrupted 10-step run's leaf by leaf, bit for bit.  The final
    state is then saved from the card and loaded on the CPU (its crcs
    checked by the load), bit-equal to the card's tensors."""
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import pytree
    from repro_torch.launch import train
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        tr = train.Trainer(train.parse_args(list(TRAIN_RESTART) + [
            "--ckpt", tmp, "--save-every", str(TRAIN_SAVE_EVERY)]))
        state, log = train.run(tr, fail_at={
            TRAIN_FAIL_AT: RuntimeError("injected fault at step 6")})
        faulted_s = time.perf_counter() - t0
        steps = [m["step"] for m in log]
        want = list(range(TRAIN_FAIL_AT)) + list(range(TRAIN_SAVE_EVERY, 10))
        if steps != want:
            fail(f"mamba2 restart: steps {steps}, want {want}")
        first = [m["loss"] for m in log[TRAIN_SAVE_EVERY:TRAIN_FAIL_AT]]
        replay = [m["loss"] for m in log[TRAIN_FAIL_AT:2 * TRAIN_FAIL_AT
                                         - TRAIN_SAVE_EVERY]]
        if first != replay:
            fail(f"mamba2 restart: replayed losses {replay} differ from the "
                 f"first pass's {first}")
        t0 = time.perf_counter()
        plain, plain_log = train.run(train.Trainer(train.parse_args(
            list(TRAIN_RESTART))))
        plain_s = time.perf_counter() - t0
        kept = log[:TRAIN_SAVE_EVERY] + log[TRAIN_FAIL_AT:]
        if [m["loss"] for m in plain_log] != [m["loss"] for m in kept]:
            fail("mamba2 restart: the faulted run's losses differ from the "
                 "uninterrupted run's")
        leaves = pytree.leaves(state)
        for i, (a, b) in enumerate(zip(leaves, pytree.leaves(plain))):
            if a.dtype != b.dtype or not torch.equal(a, b):
                fail(f"mamba2 restart: final leaf {i} differs from the "
                     f"uninterrupted run's")
        del plain
        if int(state[1]["step"]) != 10:
            fail(f"mamba2 restart: optimizer step {int(state[1]['step'])}")
        t0 = time.perf_counter()
        mgr = CheckpointManager(tmp)
        mgr.save(state, 10, extra={"next_step": 10})
        on_cpu = pytree.tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype), state)
        got, _ = mgr.restore(on_cpu, 10)
        for a, b in zip(pytree.leaves(got), leaves):
            if a.device.type != "cpu" or not torch.equal(a, b.cpu()):
                fail("mamba2 restart: the card's checkpoint, loaded on the "
                     "CPU, differs from the card's state")
        ckpt_s = time.perf_counter() - t0
        n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    c = tr.cfg
    print(f"train: {c.name} ({c.n_layers} layers, d {c.d_model}) restart at "
          f"batch {tr.args.batch} x seq {tr.args.seq}: fault at step "
          f"{TRAIN_FAIL_AT}, resumed from the step-{TRAIN_SAVE_EVERY} "
          f"checkpoint, replayed losses {replay} == first pass {first} bit "
          f"for bit; final state ({len(leaves)} leaves, "
          f"{n_bytes / 2 ** 30:.3f} GiB) bit-equal to an uninterrupted "
          f"run; the card's checkpoint loaded on the CPU bit-equal, crcs "
          f"checked; faulted run "
          f"{faulted_s:.1f} s, uninterrupted {plain_s:.1f} s, save + CPU "
          f"load {ckpt_s:.1f} s [{card}]")
    return {"losses": [m["loss"] for m in log], "faulted_s": faulted_s,
            "plain_s": plain_s, "ckpt_s": ckpt_s}


def flash_refuses_grad(dev):
    """The kernel has no backward: inputs that require grad raise on the
    card under grad mode."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (torch.randn((1, 128, 4, 64), device=dev,
                           dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    try:
        fa.flash_attention(q, k, v, causal=True)
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        print(f"train: flash_attention on CUDA inputs that require grad "
              f"raises: {e}")
        return
    fail("flash_attention returned on CUDA inputs that require grad")


def examples_phase():
    """The four examples/torch_*.py, each its own process at its default
    sizes on the card: each must exit 0."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    walls = {}
    for name in EXAMPLES:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, str(ROOT / "examples" / name)],
                           cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=600)
        walls[name] = time.perf_counter() - t0
        tail = (r.stdout + r.stderr).strip().splitlines()[-3:]
        print(f"example: {name} exit {r.returncode} in {walls[name]:.1f} s: "
              + " | ".join(tail))
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-4000:])
            fail(f"examples/{name} exited {r.returncode}")
    return walls


def train_phase(dev, card):
    """The train phase: the two training paths (no hand-written kernel
    launches), the smoke step's card-vs-CPU parity, flash's refusal of
    grad inputs, and the examples."""
    import torch
    t0 = time.perf_counter()
    out = {"stablelm": zero_launch_path(
        "lm-train-stablelm-1.6b", lambda: train_stablelm(dev, card))}
    gc.collect()
    torch.cuda.empty_cache()
    out["smoke"] = train_smoke_parity(dev)
    out["restart"] = zero_launch_path("lm-train-mamba2-370m",
                                      lambda: train_restart(dev, card))
    gc.collect()
    torch.cuda.empty_cache()
    flash_refuses_grad(dev)
    out["examples"] = examples_phase()
    out["seconds"] = time.perf_counter() - t0
    print(f"train phase: {out['seconds']:.1f} s [{card}]")
    return out


# ------------------------------------------------- 5. kernels at main-path
def visible(Sq, Sk, causal, window, device):
    """[Sq, Sk] bool: the (query, key) pairs that the causal and window
    mask lets through (query i at position i + Sk - Sq)."""
    import torch
    qpos = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=device)[None, :]
    vis = torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    if causal:
        vis &= qpos >= kpos
    if window > 0:
        vis &= qpos - kpos < window
    return vis


def flash_work(q, k, causal, window, label):
    """(bytes, FLOPs, peak) of one flash-attention call: q, k, v read and
    o written once; 4 B H D FLOPs per (query, key) pair that the mask lets
    through, at the bf16 tensor-core peak.  Prints the call's score spread
    and the median top-1 attention weight."""
    import torch
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    vis = visible(Sq, Sk, causal, window, q.device)
    pairs = int(vis.sum())
    kr = k.float().repeat_interleave(H // KV, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) / D ** 0.5
    sc = sc.masked_fill(~vis, float("nan"))
    top = torch.softmax(sc.nan_to_num(-1e30), dim=-1).amax(dim=-1)
    print(f"flash_attention, recorded {label} prefill call: attention "
          f"score std {float(sc[~sc.isnan()].std()):.1f}, median top-1 "
          f"weight {float(top.median()):.4f}")
    return (2 * nbytes(q) + 2 * nbytes(k), 4 * B * H * D * pairs,
            TENSOR_CORE_BF16_FLOPS)


def kernel_rows(calls, launches, attn):
    """Compare and time each kernel on recorded main-path inputs (``attn``:
    per LM path, the q, k, v and options of the first prefill call of each
    (causal, window) in its profiled beat)."""
    import numpy as np
    import torch
    from repro_torch.core.dataquery import popcount
    from repro_torch.kernels import (bitmask_join, clockscan, fused_delta,
                                     partitioned_join, ref, shared_groupby)
    rows = []
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device=calls["scan"][0][0].device)

    def measure(name, kern, plain, check, work, setup=None, library=None,
                calls=1):
        """Check ``kern`` against ``plain`` and time both, and ``library``
        (one PyTorch call of the same function) beside them.  ``setup``
        restores what ``kern`` writes in place (fused_delta's scan-word
        carries) before every call: the plain version first, then the
        kernel, each on the recorded inputs.  ``calls``: launches in one
        timed call set."""
        if setup is not None:
            setup()
        want = plain()
        if setup is not None:
            setup()
        got = clone_tree(kern())     # fused_delta's words are the carries
        check(got, want)
        err = max_abs_err(got, want)
        b, by = bound_ms(*work)
        ms, kernel_ms, per_call, ops, window_ops = device_ms(
            kern, KERNEL_SYMBOLS[name], setup, launches=calls)
        plain_ms = device_ms(plain, KERNEL_SYMBOLS[name], setup,
                             launches=0)[0]
        library_ms = None if library is None else \
            device_ms(library, "no kernel of this repository",
                      launches=0)[0]
        if per_call == 0:
            fail(f"{name}: the profiler saw no launch of the kernel")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b, "bound_by": by, "library_ms": library_ms,
                "calls_per_timing": calls, "per_launch_ms": ms / calls,
                "kernel_ms": kernel_ms, "kernel_launches": per_call,
                "device_ops": ops, "window_ops": window_ops,
                "wall_ms": wall_ms(kern, setup),
                "plain_wall_ms": wall_ms(plain, setup)}

    def line(name, m, **extra):
        src, replaces = KERNEL_ORIGIN[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{src}",
                     "replaces": replaces, "launches": launches[name], **m,
                     **extra})

    def row(name, *args, **kwargs):
        """One kernel's line: ``measure`` on its recorded inputs, and
        ``loss_ms``, the main path's launches times (device ms - bound)
        of one launch."""
        m = measure(name, *args, **kwargs)
        line(name, m, loss_ms=launches[name] * (m["ms"] - m["bound_ms"])
             / m["calls_per_timing"])

    # clockscan: the reseed beat's six scans, one set per timing
    scans = calls["scan"][:6]
    scan_bytes = sum(nbytes(*a[:3]) + a[3].numel()
                     + a[3].numel() * a[1].shape[1] // 8 for a in scans)
    scan_ops = sum(2 * a[0].shape[0] * a[0].shape[1] * a[1].shape[1]
                   for a in scans)
    row("clockscan", lambda: [clockscan.clockscan(*a) for a in scans],
        lambda: [ref.clockscan_ref(*a) for a in scans],
        lambda g, w: same(g, w, "clockscan (main path)"),
        (scan_bytes, scan_ops), calls=len(scans))
    rows[-1]["cold_l2_kernel_ms"] = sum(
        cold_l2_ms(lambda a=a: clockscan.clockscan(*a), "clockscan", flush)
        for a in scans)

    # shared_groupby: the last steady beat's call
    codes, vals, mask, G = calls["groupby"][-1]
    set_bits = int(popcount(mask).sum())
    Q = mask.shape[1] * 32

    def gb_check(g, w):
        same(g[0], w[0], "shared_groupby counts (main path)")
        if not torch.allclose(g[1], w[1], rtol=1e-6):
            fail("shared_groupby sums (main path)")
    row("shared_groupby", lambda: shared_groupby.shared_groupby(codes, vals, mask, G),
        lambda: ref.shared_groupby_ref(codes, vals, mask, G), gb_check,
        (nbytes(codes, vals, mask) + 2 * G * Q * 4, 2 * set_bits))
    if rows[-1]["window_ops"] > shared_groupby.DEVICE_OPS:
        fail(f"shared_groupby enqueues {rows[-1]['window_ops']} device ops "
             f"a call, over its {shared_groupby.DESIGN} design's "
             f"{shared_groupby.DEVICE_OPS}")
    rows[-1]["design"] = shared_groupby.DESIGN
    rows[-1]["cold_l2_kernel_ms"] = cold_l2_ms(
        lambda: shared_groupby.shared_groupby(codes, vals, mask, G),
        "shared_groupby", flush)
    # the bound's bytes, recounted by input: the codes, values and mask
    # words read once, the [G, Q] counts and sums written once
    rows[-1]["bound_bytes"] = {
        "codes": nbytes(codes), "vals": nbytes(vals), "mask": nbytes(mask),
        "out": 2 * G * Q * 4, "set_bits": set_bits,
        "shape": [list(codes.shape), list(mask.shape), G]}

    # partitioned_join: the reseed beat's four probes, whose buckets must
    # be laid out as the kernel's binary search needs
    joins = calls["join_partitioned"][:4]
    if not all(partitioned_join.buckets_ordered(a[2], a[3]) for a in joins):
        fail("partitioned_join: recorded buckets not in build_key_partitions'"
             " order")
    pj_bytes = sum(nbytes(*a) + a[0].numel() * 4 + nbytes(a[1])
                   for a in joins)
    pj_ops = sum(a[0].numel() * (a[2].shape[1] + a[1].shape[1]
                                 + max(1, a[2].shape[0]).bit_length())
                 for a in joins)
    row("partitioned_join", lambda: [partitioned_join.partitioned_join(*a) for a in joins],
        lambda: [ref.partitioned_join_ref(*a) for a in joins],
        lambda g, w: same(g, w, "partitioned_join (main path)"),
        (pj_bytes, pj_ops), calls=len(joins))
    rows[-1]["cold_l2_kernel_ms"] = sum(
        cold_l2_ms(lambda a=a: partitioned_join.partitioned_join(*a),
                   "partitioned_join", flush) for a in joins)

    # fused_delta: the last steady beat's launch; the work that its data
    # needs — live panes, live dirty rows, live probes — and every join's
    # rid output (its carry read, the output written: 8 Tl bytes)
    scan_in, join_in = calls["fused_delta"][-1]
    fb, fo = 0, 0
    for e in scan_in:
        C, T = e.cols.shape
        A, Q = e.lo_p.shape[1] // 32, e.lo.shape[1]
        if int(e.span) > 0:
            fb += C * T * 4 + T + T * A * 4 + nbytes(e.lo_p, e.hi_p)
            fo += 2 * C * T * 32 * A
        dn = int(e.dn)
        fb += e.rows.numel() * 4
        fb += dn * (C * 4 + 1 + Q // 8) + (nbytes(e.lo, e.hi) if dn else 0)
        fo += 2 * dn * C * Q
    for e in join_in:
        dn = int(e.dn)
        fb += e.rows.numel() * 4 + dn * (4 + e.bkeys.shape[1] * 8 + 4)
        fo += dn * e.bkeys.shape[1]
    # the same launch counted as a descriptor-driven kernel without rid
    # outputs (16 bytes of descriptor a pane tile, dirty slot and probe
    # slot), the count of the previous design, for comparison
    descriptor_bytes = fb + 16 * (
        sum(-(-e.cols.shape[1] // min(256, e.cols.shape[1]))
            + e.rows.numel() for e in scan_in)
        + sum(e.rows.numel() for e in join_in))
    fb += sum(8 * e.keys.shape[0] for e in join_in)
    recorded = [e.carry.clone() for e in scan_in]

    def restore_carries():
        for e, c in zip(scan_in, recorded):
            e.carry.copy_(c)
    row("fused_delta", lambda: fused_delta.fused_delta(scan_in, join_in),
        lambda: ref.fused_delta_ref(scan_in, join_in),
        lambda g, w: same(g, w, "fused_delta (main path)"), (fb, fo),
        setup=restore_carries)
    rows[-1]["descriptor_bound_ms"] = bound_ms(descriptor_bytes, fo)[0]

    def cold_carries():
        restore_carries()
        flush.zero_()
    rows[-1]["cold_l2_kernel_ms"] = device_ms(
        lambda: fused_delta.fused_delta(scan_in, join_in),
        KERNEL_SYMBOLS["fused_delta"], setup=cold_carries)[1]
    if rows[-1]["device_ops"] > 1 + len(join_in):
        fail(f"fused_delta enqueues {rows[-1]['device_ops']} device ops a "
             f"call, over 1 + {len(join_in)} joins")

    # bitmask_join: the fold path's migration beat (address ⋈ country)
    keys_l, mask_l, keys_r, mask_r, valid_r = calls["join_block"][-1]
    Tl, W = mask_l.shape
    row("bitmask_join",
        lambda: bitmask_join.bitmask_join(keys_l, mask_l, keys_r, mask_r,
                                          valid_r),
        lambda: ref.bitmask_join_ref(keys_l, mask_l, keys_r, mask_r, valid_r),
        lambda g, w: same(g, w, "bitmask_join (fold path)"),
        (nbytes(keys_l, mask_l, keys_r, mask_r, valid_r) + Tl * 4
         + nbytes(mask_l), Tl * keys_r.numel() + Tl * W))
    rows[-1]["staged"] = bitmask_join.stage_bytes(keys_r.numel(), W) > 0
    # the same call with the right side's rows shuffled: its staged rows
    # are then out of key order and the lanes find rids by the scan
    perm = torch.as_tensor(np.random.default_rng(SEED).permutation(
        keys_r.numel()), device=keys_r.device)
    shuffled = (keys_l, mask_l, keys_r[perm].contiguous(),
                mask_r[perm].contiguous(), valid_r[perm].contiguous())
    same(bitmask_join.bitmask_join(*shuffled),
         ref.bitmask_join_ref(*shuffled), "bitmask_join (fold path, shuffled)")
    rows[-1]["shuffled_kernel_ms"] = device_ms(
        lambda: bitmask_join.bitmask_join(*shuffled),
        KERNEL_SYMBOLS["bitmask_join"])[1]
    rows[-1]["cold_l2_kernel_ms"] = cold_l2_ms(
        lambda: bitmask_join.bitmask_join(keys_l, mask_l, keys_r, mask_r,
                                          valid_r), "bitmask_join", flush)

    # delta_scan / delta_join: one chained steady beat's grouped calls over
    # its 7 stages and its 4 partitioned joins; every slot (pads too) is
    # computed, on its clamped row
    ds, = calls["scan_delta"][-1]
    ds_bytes = sum(e.rows.numel() * (4 + e.cols.shape[0] * 4 + 1
                                     + e.lo.shape[1] // 8)
                   + nbytes(e.lo, e.hi) for e in ds)
    ds_ops = sum(2 * e.rows.numel() * e.cols.shape[0] * e.lo.shape[1]
                 for e in ds)
    row("delta_scan", lambda: fused_delta.delta_scan(ds),
        lambda: ref.delta_scans_ref(ds),
        lambda g, w: same(g, w, "delta_scan (chained path)"),
        (ds_bytes, ds_ops))
    rows[-1]["stages"] = len(ds)
    rows[-1]["cold_l2_kernel_ms"] = cold_l2_ms(
        lambda: fused_delta.delta_scan(ds), "delta_scan", flush)
    # delta_join's binary search needs build_key_partitions' layout: held
    # on every recorded call's buckets
    for (join_in,) in calls["join_delta"]:
        if not all(partitioned_join.buckets_ordered(e.bkeys, e.brows)
                   for e in join_in):
            fail("delta_join: recorded buckets not in build_key_partitions'"
                 " order")
    # what each slot needs of the sorted layout: its row, key and rid,
    # and the (key, row) pairs of its bucket's binary search (log2 B + 1
    # steps); each join's bounds once; a compare a route and a search step
    dj, = calls["join_delta"][-1]
    dj_bytes = sum(e.rows.numel() * (12 + 8 * e.bkeys.shape[1].bit_length())
                   + nbytes(e.bounds) for e in dj)
    dj_ops = sum(e.rows.numel() * (e.bkeys.shape[0].bit_length()
                                   + e.bkeys.shape[1].bit_length())
                 for e in dj)
    row("delta_join", lambda: fused_delta.delta_join(dj),
        lambda: ref.delta_joins_ref(dj),
        lambda g, w: same(g, w, "delta_join (chained path)"),
        (dj_bytes, dj_ops))
    rows[-1]["joins"] = len(dj)
    rows[-1]["cold_l2_kernel_ms"] = cold_l2_ms(
        lambda: fused_delta.delta_join(dj), "delta_join", flush)

    # flash_attention: the first recorded prefill call of yi-6b (B 1, S
    # 512, H 32, KV 4, D 128, bf16, causal) is the row; every other
    # (causal, window, Sq, Sk) that an LM path launched rides along in
    # "shapes": gemma3-27b's 2048-token window-1024 and causal layers,
    # qwen2-moe-a2.7b's 512-token layer (H 16 over 16 KV heads),
    # recurrentgemma-2b's (D 256, 10 heads over 1, window 2048), whisper-
    # small's encoder (1536, not causal), decoder (192, causal) and cross
    # (192 over 1536) layers, llama-3.2-vision-90b's self (512, causal)
    # and cross (512 over 6404) layers
    from repro_torch import kernels as K
    from repro_torch.kernels import flash_attention as fa
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def call_label(path, causal, window, Sq, Sk):
        size = f"{Sq}" if Sq == Sk else f"{Sq} over {Sk}"
        kind = (f"window {window}" if window else "causal" if causal
                else "not causal")
        return f"{path[3:]} {size} {kind}"
    calls_fa = [(call_label(path, *key), c) for path in LM_PATHS
                for key, c in attn.get(path, {}).items()]
    shapes = []
    for label, c in calls_fa:
        q, k, v = c["q"], c["k"], c["v"]
        causal, window = c["causal"], c["window"]
        if fa.route(q.dtype, q.shape[3]) != "wgmma":
            fail(f"flash_attention ({label}): {q.dtype} D {q.shape[3]} does "
                 f"not take the tensor-core route")
        work = flash_work(q, k, causal, window, label)

        def kern(q=q, k=k, v=v, causal=causal, window=window):
            return fa.flash_attention(q, k, v, causal=causal, window=window)

        def plain(q=q, k=k, v=v, causal=causal, window=window):
            return ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window)

        def fa_check(g, w, label=label):
            if not torch.allclose(g.float(), w.float(), rtol=2e-2, atol=1e-1):
                fail(f"flash_attention ({label}): max abs err "
                     f"{max_abs_err(g, w)}")
        # SDPA on the same inputs in its [B, H, S, D] view: is_causal for
        # a causal call, no mask for a call that sees every key, else the
        # visible band as a boolean mask (built here, outside the timed
        # call); checked like the kernel
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        band = None if not window else \
            visible(q.shape[1], k.shape[1], causal, window, q.device)

        def library(qt=qt, kt=kt, vt=vt, band=band, causal=causal):
            return sdpa(qt, kt, vt, attn_mask=band,
                        is_causal=causal and band is None, enable_gqa=True)
        fa_check(library().transpose(1, 2), plain(), label="SDPA, " + label)
        m = measure("flash_attention", kern, plain, fa_check, work,
                    library=library)
        m["launches"] = c["launches"]
        m["loss_ms"] = c["launches"] * (m["ms"] - m["bound_ms"])
        shapes.append(dict(shape=label, head_dim=q.shape[3],
                           query_tile=fa.tiles("wgmma", q.shape[3])[0], **m))
    line("flash_attention", {k2: v2 for k2, v2 in shapes[0].items()
                             if k2 not in ("shape", "launches", "head_dim",
                                           "query_tile")},
         loss_ms=sum(x["loss_ms"] for x in shapes), shapes=shapes)

    # the CUDA-core kernel on yi-6b's call and on recurrentgemma-2b's (D
    # 256), straight through its launcher: timed, and compared, never
    # counted
    for at, (lbl, c) in (("", calls_fa[0]), ("_d256", next(
            x for x in calls_fa if x[1]["q"].shape[3] == 256))):
        q, k, v = c["q"], c["k"], c["v"]
        causal, window = c["causal"], c["window"]

        def simt(q=q, k=k, v=v, causal=causal, window=window):
            B, Sq, H, D = q.shape
            out = torch.empty_like(q)
            K.check_launch(K.library().shareddb_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                Sq, k.shape[1], H, k.shape[2], D, int(causal), int(window),
                1, fa.q_tiles(Sq, fa.TILES["simt"][0]), K.stream_of(q)),
                "flash_attention (simt)")
            return out
        if not torch.allclose(simt().float(), ref.flash_attention_ref(
                q, k, v, causal=causal, window=window).float(), rtol=2e-2,
                atol=1e-1):
            fail(f"flash_attention (simt, {lbl}) disagrees with its plain "
                 f"version")
        rows[-1][f"simt{at}_ms"], rows[-1][f"simt{at}_kernel_ms"] = \
            device_ms(simt, FLASH_SIMT_SYMBOL)[:2]
    if sum(x["launches"] for x in shapes) != launches["flash_attention"]:
        fail("flash_attention: the recorded shapes do not cover every "
             "launch of the main path")
    return rows


# ---------------------------------------------------------------- the mesh
MESH_SHAPE = (2, 2)              # (data, model): four simulated ranks
MESH_SERVER = {"capacity": 4, "max_seq": 1024, "prefill_len": 512,
               "kernels": "hopper"}
MESH_PROMPTS = (64, 200, 350, 512)      # prompt tokens of the 4 requests
MESH_NEW_TOKENS = 8
MESH_REL_TOL = 2e-2         # of each layer's scale (LM_REL_TOL's gate)
MESH_RECORD_BEAT = 5        # a decode-only beat after the profiled one
# the graphed mesh server's decode logits against its eager twin's: the
# graphed-vs-eager gate of the LM paths (LM_EAGER_REL_TOL)
MESH_GRAPH_REL_TOL = 1e-3
# each float32 prefill layer on the mesh's own input: float32 rounding
# grown through one layer (~60x, the plain-attention twin's layer 1) is
# ~1e-5 of scale; a fault shows at a bf16 ulp (~4e-3) or more
MESH_F32_LAYER_TOL = 1e-3
# the dry-run cells of the phase: one full config of each family, at
# train_4k and decode_32k on the 256-rank mesh and decode_32k on the
# 512-rank one (the whole matrix: ``python -m repro_torch.launch.dryrun``)
MESH_DRYRUN_ARCHS = ("yi-6b", "qwen2-moe-a2.7b", "recurrentgemma-2b",
                     "mamba2-370m", "whisper-small", "llama-3.2-vision-90b")
MESH_DRYRUN_CELLS = (("single", "train_4k,decode_32k"),
                     ("multi", "decode_32k"))
MESH_DRYRUN_TIMEOUT_S = 600
DEVICE_BYTES = 80 * 2 ** 30


def start_dryrun(out_dir):
    """One process per family, each running the family's cells of the
    dry-run CLI over its fake process groups (CPU only, at the lowest
    CPU priority; they overlap the phase's untimed checks and the
    elastic shrink).  Returns [(arch, process, out file)]."""
    import os
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch in MESH_DRYRUN_ARCHS:
        out = out_dir / f"{arch}.json"
        cmd = " && ".join(
            f"{sys.executable} -m repro_torch.launch.dryrun --arch {arch} "
            f"--shape {shapes} --mesh {mesh} --no-extrapolate --force "
            f"--out {out}" if i == 0 else
            f"{sys.executable} -m repro_torch.launch.dryrun --arch {arch} "
            f"--shape {shapes} --mesh {mesh} --no-extrapolate --out {out}"
            for i, (mesh, shapes) in enumerate(MESH_DRYRUN_CELLS))
        procs.append((arch, subprocess.Popen(
            ["nice", "-n", "19", "bash", "-c", cmd], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            out))
    return procs


def finish_dryrun(procs):
    """Wait for the dry-run processes; print one line a cell; fail on an
    error cell or a failed process.  Returns the cells' records."""
    cells = {}
    for arch, proc, out in procs:
        try:
            text, _ = proc.communicate(timeout=MESH_DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"mesh dry-run of {arch}: over {MESH_DRYRUN_TIMEOUT_S} s")
        if proc.returncode != 0 or not out.exists():
            print(text[-3000:])
            fail(f"mesh dry-run of {arch}: exit {proc.returncode}")
        cells.update(json.loads(out.read_text()))
    for key, rec in sorted(cells.items()):
        if rec["status"] == "error":
            fail(f"mesh dry-run {key}: {rec['error']}")
        if rec["status"] == "skipped":
            print(f"mesh dry-run {key}: skipped ({rec['reason'][:60]})")
            continue
        m, r = rec["memory"], rec["roofline"]
        arg, temp = m["argument_bytes_per_device"], m["temp_bytes_per_device"]
        print(f"mesh dry-run {key}: ok; argument {arg / 2 ** 30:.3f} GiB + "
              f"temp {temp / 2 ** 30:.3f} GiB a device "
              f"({'fits' if arg + temp <= DEVICE_BYTES else 'exceeds'} "
              f"80 GiB); FLOPs {rec['hlo_flops']:.4e} (model "
              f"{rec['model_flops']:.4e}); collective bytes "
              f"{rec['collective_bytes']:.4e}; dominant {r['dominant']} "
              f"(step bound {r['step_time_s']:.6f} s on "
              f"{rec['n_chips']} H100s, analytic) ({rec['wall_s']} s)")
    return cells


class StepLog:
    """A server's logits at every prefill and decode step (rows of the
    slots active in that step), on the host, in order."""

    def __init__(self, srv):
        from repro_torch.core.device import host_numpy
        self.logits = []
        prefill, decode = srv._prefill, srv._decode

        def rec_prefill(*a):
            out = prefill(*a)
            self.logits.append(host_numpy(out[0].float()))
            return out

        def rec_decode(p, c, t, pos):
            out = decode(p, c, t, pos)
            live = [x is not None for x in srv._slots]
            self.logits.append(host_numpy(out[0].float())[live])
            return out
        srv._prefill, srv._decode = rec_prefill, rec_decode


def mesh_drain(srv, prompts, profiled_beat, recorder=None, beat_logits=None):
    """Submit ``prompts`` and beat to drain; beat ``profiled_beat`` (a
    decode-only beat) under torch.profiler, and beat MESH_RECORD_BEAT
    (decode-only too) inside ``recorder``'s context when one is given;
    each beat's decode logits of its live rows appended to
    ``beat_logits`` (read after the beat's wall is taken).  Returns
    (outputs by request, wall seconds, the profiled beat's {wall_ms,
    busy_ms, host_ops})."""
    import torch
    from repro_torch.core.device import host_numpy
    for pr in prompts:
        srv.submit(pr, max_new_tokens=MESH_NEW_TOKENS)
    done, beat, profiled, decode_walls = [], 0, None, []
    t0 = time.perf_counter()
    while srv.pending() or srv.active():
        prof = beat_profiler() if beat == profiled_beat else None
        rec = recorder if beat == MESH_RECORD_BEAT else None
        with prof or contextlib.nullcontext(), \
                rec or contextlib.nullcontext():
            tb = time.perf_counter()
            srv.dispatch()
            live = [r is not None for r in srv._slots]
            done += srv.collect()
            torch.cuda.synchronize()
            wall = time.perf_counter() - tb
        if beat_logits is not None:
            beat_logits.append(host_numpy(srv._logits.float())[live])
        if (prof or rec) is not None and srv.last_admitted:
            fail(f"mesh: beat {beat} admitted a request")
        if prof is not None:
            busy, n, top = busy_ms(prof)
            profiled = {"wall_ms": wall * 1e3, "busy_ms": busy,
                        "device_ops": n, "host_ops": host_ops(prof),
                        "top": top}
        elif rec is None and not srv.last_admitted:
            decode_walls.append(wall * 1e3)
        beat += 1
    if recorder is not None and beat <= MESH_RECORD_BEAT:
        fail(f"mesh: drained in {beat} beats, before beat {MESH_RECORD_BEAT}")
    if profiled is not None:
        profiled["median_unprofiled_decode_wall_ms"] = statistics.median(
            decode_walls) if decode_walls else float("nan")
    outs = [r.output for r in sorted(done, key=lambda r: r.id)]
    return outs, time.perf_counter() - t0, profiled


def rank_bytes(tree, rank):
    """Rank ``rank``'s bytes of a tree of DTensors: a LocalTensor local
    shard's rank's, a plain local tensor's (the same on every rank)."""
    from repro_torch.core import pytree
    total = 0
    for t in pytree.leaves(tree):
        lt = t._local_tensor
        lt = getattr(lt, "_local_tensors", {rank: lt})[rank]
        total += lt.numel() * lt.element_size()
    return total


class LayerLog:
    """Rank 0's input and output residual of every prefill sublayer of a
    mesh server's first admission (``transformer._sublayer_train``),
    as plain tensors."""

    def __init__(self, n_layers):
        from repro_torch.models import transformer
        self.tf, self.n, self.io = transformer, n_layers, []
        self.orig = transformer._sublayer_train

    def __enter__(self):
        def rec(p, spec, x, *a):
            out = self.orig(p, spec, x, *a)
            if len(self.io) < self.n:
                self.io.append((spec, rank0(x), rank0(out[0])))
            return out
        self.tf._sublayer_train = rec
        return self

    def __exit__(self, *exc):
        self.tf._sublayer_train = self.orig


class DecodeLog:
    """Rank 0's view of every decode sublayer of one beat
    (``transformer._sublayer_decode``): its input residual, positions,
    layer cache before and after the in-place writes, and output
    residual, as plain tensors; and the beat's live rows."""

    def __init__(self, srv):
        from repro_torch.models import transformer
        self.tf, self.srv, self.io = transformer, srv, []
        self.orig = transformer._sublayer_decode

    def __enter__(self):
        self.live = [r is not None for r in self.srv._slots]
        self.n_real = [min(len(r.prompt), self.srv.prefill_len) if r
                       else 0 for r in self.srv._slots]

        def rec(p, spec, x, cfg, positions, cache, axes):
            before = {k: rank0(v) for k, v in cache.items()}
            x_in, pos = rank0(x), rank0(positions)
            out = self.orig(p, spec, x, cfg, positions, cache, axes)
            self.io.append((spec, x_in, pos, before, rank0(out[0]),
                            {k: rank0(v) for k, v in cache.items()}))
            return out
        self.tf._sublayer_decode = rec
        return self

    def __exit__(self, *exc):
        self.tf._sublayer_decode = self.orig


class CacheSnapshot:
    """A plain server's layer-0 cache as it stands before one beat."""

    def __init__(self, srv):
        self.srv, self.cache = srv, None

    def __enter__(self):
        from repro_torch.models import transformer as tf
        self.cache = {k: v.clone() for k, v in
                      tf.layer_params(self.srv.cache["g0"], 0).items()}
        return self

    def __exit__(self, *exc):
        pass


def rank0(t):
    """Rank 0's full value of a DTensor over LocalTensors, a plain copy
    (of a plain tensor: a copy)."""
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return getattr(t, "_local_tensors", {0: t})[0].clone()


def mesh_layer_gate(cfg, params, io, logits, last, card):
    """Each recorded sublayer of the mesh prefill against the unsharded
    sublayer run on the mesh's own input (MESH_REL_TOL of its scale),
    and the mesh's logits against the unsharded unembedding of its last
    residual.  Returns the worst relative error."""
    import torch
    from repro_torch.models import transformer as tf
    S = io[0][1].shape[1]
    pos = torch.arange(S, device=io[0][1].device)[None]
    worst = 0.0
    for layer, (spec, x_in, x_out) in enumerate(io):
        want = tf._sublayer_train(tf.layer_params(params["g0"], layer), spec,
                                  x_in, cfg, pos, None, 0, "hopper")[0]
        err = rel_err(x_out, want)
        worst = max(worst, err)
        if err > MESH_REL_TOL:
            fail(f"mesh: prefill layer {layer} differs from the unsharded "
                 f"layer on its own input by {err:.3e} of scale")
    want = tf._unembed(params, cfg, io[-1][2][:, last:last + 1])[:, 0]
    err = rel_err(logits, want)
    if err > MESH_REL_TOL:
        fail(f"mesh: prefill logits differ from the unsharded unembedding "
             f"of the mesh's last residual by {err:.3e} of scale")
    print(f"mesh: lm-yi-6b-mesh2x2 first admission: {len(io)} prefill "
          f"layers each within {worst:.3e} of scale of the unsharded layer "
          f"on its own input, logits within {err:.3e} (gate "
          f"{MESH_REL_TOL}) [{card}]")
    return max(worst, err)


def mesh_decode_gate(cfg, params, dec, base_cache, card):
    """Each decode sublayer of the mesh's recorded beat against the
    unsharded sublayer run on the mesh's own input and a copy of its
    cache: the output residual of the live rows and the K/V written in
    place within MESH_REL_TOL of scale, the positions written equal.
    Then the cache that admission inserted: layer 0's positions equal
    to the unsharded server's at the same beat, its K/V at the prompt
    positions within MESH_REL_TOL (layer 0 hears the same tokens on
    both servers).  Returns the worst relative error."""
    import torch
    from repro_torch.models import transformer as tf
    live = torch.tensor(dec.live, device=dec.io[0][1].device)
    worst = 0.0
    for layer, (spec, x_in, pos, before, x_out, after) in \
            enumerate(dec.io):
        cache = {k: v.clone() for k, v in before.items()}
        want = tf._sublayer_decode(tf.layer_params(params["g0"], layer),
                                   spec, x_in, cfg, pos, cache)[0]
        errs = [rel_err(x_out[live], want[live])] + [
            rel_err(after[f], cache[f]) for f in ("k", "v")]
        worst = max(worst, *errs)
        if max(errs) > MESH_REL_TOL or not torch.equal(after["pos"],
                                                        cache["pos"]):
            fail(f"mesh: decode layer {layer} differs from the unsharded "
                 f"layer on its own input and cache: output, K, V "
                 f"{errs} of scale, positions equal "
                 f"{torch.equal(after['pos'], cache['pos'])}")
    ins = dec.io[0][3]
    if not torch.equal(ins["pos"], base_cache["pos"]):
        fail("mesh: layer 0's cached positions differ from the unsharded "
             "server's")
    prompt = (ins["pos"] >= 0) & (ins["pos"] < torch.tensor(
        dec.n_real, device=ins["pos"].device)[:, None])
    ins_err = max(rel_err(ins[f][prompt], base_cache[f][prompt])
                  for f in ("k", "v"))
    if ins_err > MESH_REL_TOL:
        fail(f"mesh: layer 0's inserted prompt K/V differ from the "
             f"unsharded server's by {ins_err:.3e} of scale")
    print(f"mesh: lm-yi-6b-mesh2x2 decode-only beat {MESH_RECORD_BEAT}: "
          f"{len(dec.io)} decode layers (output of {sum(dec.live)} live "
          f"rows, K/V written in place) each within {worst:.3e} of scale "
          f"of the unsharded layer on its own input and cache, positions "
          f"equal; layer 0's inserted prompt K/V within {ins_err:.3e} of "
          f"the unsharded server's, positions equal (gate {MESH_REL_TOL})"
          f" [{card}]")
    return max(worst, ins_err)


def step_divergence(got, want):
    """Per step, max |got - want| / max |want| of two StepLogs' logits."""
    import numpy as np
    return [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(got.logits, want.logits)]


def mesh_f32_witness(cfg, params, prompt, dev, card):
    """The first admission's prefill in float32 (the servers' bf16
    ``params`` cast up) on the (2, 2) mesh, unsharded, and unsharded on
    the plain attention (the twin), through the model's prefill as the
    server admits it.  Gate: each mesh layer within MESH_F32_LAYER_TOL of
    scale of the unsharded layer on the mesh's own input, at the
    prompt's positions (the pads after them never reach the logits).
    Measured: each chain's divergence from the unsharded run, layer by
    layer, and the end-to-end logits' (random weights' one-hot attention
    grows a float32 rounding difference as it grows a bf16 one).
    Returns (worst layer error, {run: [divergence by layer]},
    {run: logits divergence})."""
    import numpy as np
    import torch
    from torch.distributed._local_tensor import LocalTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import pytree
    from repro_torch.launch.mesh import make_axes
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import MeshAxes
    from repro_torch.models.registry import get_model
    from repro_torch.core.device import host_numpy

    def up(tree):
        return pytree.tree_map(lambda t: t.float(), tree)
    P = MESH_SERVER["prefill_len"]
    n = min(len(prompt), P)
    toks = torch.from_numpy(np.asarray(
        [prompt[-P:] + [0] * (P - len(prompt))], np.int64)).to(dev)
    runs = {}
    for name, kernels, mode in (
            ("unsharded", "hopper", None), ("twin", "torch", None),
            ("mesh", "hopper", LocalTensorMode(math.prod(MESH_SHAPE)))):
        with mode or contextlib.nullcontext():
            axes = MeshAxes() if mode is None else make_axes(
                init_device_mesh("cuda", MESH_SHAPE,
                                 mesh_dim_names=("data", "model")))
            api = get_model(cfg, axes, device=dev, kernels=kernels)
            # on the mesh each bf16 leaf is placed, then cast: no full
            # float32 leaf is split, no whole bf16 copy waits for the cast
            p32 = up(params) if mode is None else pytree.dict_map(
                lambda t, s: axes.distribute(t, *s).float(), params,
                api.param_specs())
            with LayerLog(cfg.n_layers) as layers:
                out, _ = api.prefill(p32, {"tokens": axes.distribute(toks)},
                                     cache_capacity=MESH_SERVER["max_seq"],
                                     last_pos=n - 1)
            runs[name] = (host_numpy(out.float()), layers.io)
            del p32, out, layers
        gc.collect()
        torch.cuda.empty_cache()
    pos = torch.arange(P, device=dev)[None]
    worst = 0.0
    for layer, (spec, x_in, x_out) in enumerate(runs["mesh"][1]):
        want = tf._sublayer_train(up(tf.layer_params(params["g0"], layer)),
                                  spec, x_in, cfg, pos, None, 0, "hopper")[0]
        err = rel_err(x_out[:, :n], want[:, :n])
        worst = max(worst, err)
        if err > MESH_F32_LAYER_TOL:
            fail(f"mesh: float32 prefill layer {layer} differs from the "
                 f"unsharded layer on its own input by {err:.3e} of scale")
    base_l, base_io = runs.pop("unsharded")
    chain = {k: [rel_err(io[2][:, :n], b[2][:, :n])
                 for io, b in zip(r[1], base_io)] for k, r in runs.items()}
    ends = {k: float(np.abs(r[0] - base_l).max() / np.abs(base_l).max())
            for k, r in runs.items()}
    at = sorted({i for i in (0, 1, 2, 4, 8, 16) if i < cfg.n_layers}
                | {cfg.n_layers - 1})

    def picked(k):
        return ", ".join(f"{chain[k][i]:.3e}" for i in at)
    print(f"mesh: lm-yi-6b-mesh2x2 float32 first prefill: {cfg.n_layers} "
          f"mesh layers each within {worst:.3e} of scale of the unsharded "
          f"layer on its own input (gate {MESH_F32_LAYER_TOL}); residual "
          f"beside the unsharded run's at layers {at}: mesh [{picked('mesh')}"
          f"], plain-attention twin [{picked('twin')}]; logits (measured, "
          f"not gated): mesh {ends['mesh']:.3e}, twin {ends['twin']:.3e} of "
          f"scale [{card}]")
    return worst, chain, ends


# (d) the elastic shrink: stablelm-1.6b (the train cell's model) at full
# width, depth cut 24 -> 4 layers for chip time; 2 steps on (1, 2, 2)
# (four simulated ranks), checkpoint, shrink to what 2 chips allow,
# restore, 2 more steps
ELASTIC_ARCH, ELASTIC_LAYERS = "stablelm-1.6b", 4
ELASTIC_ARGS = ("--arch", ELASTIC_ARCH, "--seq", "4096", "--batch", "2",
                "--lr", "3e-3")
ELASTIC_LADDER = [(1, 2, 2), (1, 1, 2), (1, 1, 1)]
ELASTIC_FROM, ELASTIC_ALIVE, ELASTIC_TO = (1, 2, 2), 2, (1, 1, 2)
ELASTIC_STEPS = 2           # steps on each rung
# the first resumed step against an unsharded step from the same
# restored state on the same batch: the loss (relative) and each
# parameter leaf's difference as a share of the unsharded step's change
# of that leaf.  bf16: rounding of a correct split (tp partial sums
# rounded on each rank), bounded at a quarter of the step; the witness,
# the unsharded bf16 step beside the same step in float32, measures how
# far bf16 rounding alone moves a step.  float32: the same step on the
# mesh and unsharded, where rounding is ~1e-7 and a wrong placement or a
# missing reduction moves a leaf by its whole step
ELASTIC_LOSS_RTOL = 1e-2
ELASTIC_STEP_TOL = 0.25
ELASTIC_F32_LOSS_RTOL = 1e-5
ELASTIC_F32_STEP_TOL = 1e-3


def same_bits(a, b) -> bool:
    """Whether two arrays of one shape hold the same bytes (NaNs
    included)."""
    import numpy as np
    return a.shape == b.shape and np.array_equal(
        np.ascontiguousarray(a).reshape(-1).view(np.uint8),
        np.ascontiguousarray(b).reshape(-1).view(np.uint8))


def step_shares(after, want, before):
    """Per parameter leaf: ||after - want|| / ||want - before|| (float64),
    the difference from ``want`` as a share of ``want``'s step."""
    out = []
    for a, w, b in zip(after, want, before):
        a, w, b = (t.double() for t in (a, w, b))
        step = float((w - b).norm())
        out.append(float((a - w).norm()) / step if step else
                   float((a - w).norm()))
    return out


def elastic_phase(dev, card):
    """The ladder's shrink-and-resume on the card
    (``runtime/elastic.shrink_and_resume``): ELASTIC_STEPS steps of
    stablelm-1.6b (full width, ELASTIC_LAYERS layers, batch 2 x 4096,
    bf16 parameters, float32 moments) on rung (1, 2, 2) of four
    simulated ranks, the checkpoint, ``shrink_plan`` for ELASTIC_ALIVE
    chips, the group re-formed at the target's size, the restore into the
    target's analytic template, and ELASTIC_STEPS more steps.  Gates:
    every restored parameter and moment bit-equal to the checkpoint's
    bytes, the step counter resumed, and the first resumed step's loss
    and parameters against an unsharded step from the same restored
    state on the same batch, in bf16 (ELASTIC_LOSS_RTOL /
    ELASTIC_STEP_TOL) and, from float32 copies, in float32
    (ELASTIC_F32_*); the witness: the unsharded bf16 step beside its
    float32 twin.  Returns the record."""
    import dataclasses
    import shutil
    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import pytree
    from repro_torch.core.device import host_tensor
    from repro_torch.launch import dryrun, train
    from repro_torch.runtime.elastic import (ElasticMeshManager,
                                             shrink_and_resume)
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(ELASTIC_ARCH),
                              n_layers=ELASTIC_LAYERS)
    ckdir = ROOT / "build" / "elastic-ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    args = train.parse_args(list(ELASTIC_ARGS) + ["--ckpt", str(ckdir)])
    mgr = ElasticMeshManager(ladder=list(ELASTIC_LADDER))
    walls_b, losses_b = [], []
    with train.deterministic(), shrink_and_resume(
            mgr, ELASTIC_FROM, ELASTIC_ALIVE, CheckpointManager(str(ckdir)),
            steps=ELASTIC_STEPS, global_batch=args.batch,
            regroup=dryrun.simulated_group,
            build=lambda axes: train.Trainer(args, axes=axes, cfg=cfg)) as r:
        target = r["plan"]["target"]
        if target != ELASTIC_TO:
            fail(f"elastic: shrink_plan({ELASTIC_FROM}, {ELASTIC_ALIVE}) "
                 f"gave {target}, want {ELASTIC_TO}")
        trainer, state = r["trainer"], r["state"]
        if trainer.device != dev or \
                trainer.api.axes.mesh.device_type != dev.type:
            fail(f"elastic: the resumed trainer runs on {trainer.device}")
        step_dir = ckdir / f"step_{ELASTIC_STEPS:08d}"
        saved = np.load(step_dir / "shard_0.npz")
        for path, t in pytree.flatten_with_path(state):
            got = host_tensor(t)
            if got.dtype == torch.bfloat16:     # stored as its uint16 bits
                got = got.view(torch.int16)
            if not same_bits(got.numpy(), saved[pytree.path_key(path)]):
                fail(f"elastic: restored leaf {pytree.path_key(path)} "
                     f"differs from the checkpoint")
        del saved
        ck_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
        if int(host_tensor(state[1]["step"])) != ELASTIC_STEPS:
            fail(f"elastic: the optimizer's step resumed at "
                 f"{int(host_tensor(state[1]['step']))}")
        # the restored state whole, on the card, for the unsharded steps;
        # the first resumed step in float32 on the mesh (a copy)
        restored = pytree.tree_map(rank0, state)
        batch = trainer.batch(ELASTIC_STEPS)
        loss32_m, p32, _, _ = trainer.api.train_step(
            pytree.tree_map(lambda t: t.float(), state[0]),
            pytree.tree_map(torch.clone, state[1]), batch)
        loss32_m, p32 = float(loss32_m), [rank0(t) for t in
                                          pytree.leaves(p32)]
        for step in range(ELASTIC_STEPS, 2 * ELASTIC_STEPS):
            t0 = time.perf_counter()
            state, m = trainer.step_fn(state, step)
            walls_b.append(time.perf_counter() - t0)
            losses_b.append(m["loss"])
            if step == ELASTIC_STEPS:
                resumed = [rank0(t) for t in pytree.leaves(state[0])]
        if int(host_tensor(state[1]["step"])) != 2 * ELASTIC_STEPS:
            fail("elastic: the optimizer's step did not advance")
        del state, trainer, batch
    log_a, save_s, restore_s = r["log"], r["save_s"], r["restore_s"]
    del r
    gc.collect()
    torch.cuda.empty_cache()
    # the same step unsharded from the same restored state on the same
    # batch, in bf16 and in float32
    plain = train.Trainer(args, cfg=cfg)
    before = [t.clone() for t in pytree.leaves(restored[0])]
    batch = plain.batch(ELASTIC_STEPS)
    with train.deterministic():
        loss_u, want, _, _ = plain.api.train_step(
            *pytree.tree_map(torch.clone, restored), batch)
        loss32_u, want32, _, _ = plain.api.train_step(
            pytree.tree_map(lambda t: t.float(), restored[0]), restored[1],
            batch)
    loss_u, loss32_u = float(loss_u), float(loss32_u)
    want, want32 = pytree.leaves(want), pytree.leaves(want32)
    shares = step_shares(resumed, want, before)
    shares32 = step_shares(p32, want32, before)
    witness = step_shares(want, want32, before)
    loss_err = abs(losses_b[0] - loss_u) / abs(loss_u)
    loss32_err = abs(loss32_m - loss32_u) / abs(loss32_u)
    loss_wit = abs(loss_u - loss32_u) / abs(loss32_u)
    losses = [m["loss"] for m in log_a] + losses_b
    print(f"elastic: {ELASTIC_ARCH} (full width, {ELASTIC_LAYERS} of "
          f"{get_config(ELASTIC_ARCH).n_layers} layers) at batch "
          f"{args.batch} x {args.seq}: {ELASTIC_STEPS} steps on "
          f"{ELASTIC_FROM} (walls "
          f"{[round(m['wall_s'] * 1e3, 3) for m in log_a]} ms), checkpoint "
          f"{ck_bytes} bytes saved in {save_s:.3f} s, shrink_plan("
          f"{ELASTIC_FROM}, {ELASTIC_ALIVE} chips) -> {target}, restored "
          f"in {restore_s:.3f} s (every leaf bit-equal, step "
          f"{ELASTIC_STEPS}), {ELASTIC_STEPS} steps on {target} (walls "
          f"{[round(w * 1e3, 3) for w in walls_b]} ms); losses {losses} "
          f"[{card}]")
    print(f"elastic: the first resumed step beside an unsharded step from "
          f"the same restored state on the same batch: bf16 loss "
          f"{losses_b[0]} vs {loss_u} ({loss_err:.3e} relative, gate "
          f"{ELASTIC_LOSS_RTOL}), parameters within {max(shares):.3e} of "
          f"the unsharded step's change, leaf by leaf (gate "
          f"{ELASTIC_STEP_TOL}); float32 loss {loss32_err:.3e} (gate "
          f"{ELASTIC_F32_LOSS_RTOL}), parameters {max(shares32):.3e} (gate "
          f"{ELASTIC_F32_STEP_TOL}); witness, the unsharded bf16 step "
          f"beside its float32 twin: loss {loss_wit:.3e}, parameters "
          f"{max(witness):.3e} [{card}]")
    if not all(map(math.isfinite, losses)) or loss_err > ELASTIC_LOSS_RTOL:
        fail(f"elastic: resumed loss {losses_b[0]} vs the unsharded "
             f"step's {loss_u}")
    if max(shares) > ELASTIC_STEP_TOL:
        fail(f"elastic: the resumed step's parameters differ from the "
             f"unsharded step's by {max(shares):.3e} of its change")
    if loss32_err > ELASTIC_F32_LOSS_RTOL or \
            max(shares32) > ELASTIC_F32_STEP_TOL:
        fail(f"elastic: in float32 the resumed step differs from the "
             f"unsharded one: loss {loss32_err:.3e}, parameters "
             f"{max(shares32):.3e} of its change")
    del plain, restored, resumed, want, want32, p32, before
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ckdir, ignore_errors=True)
    return {"arch": ELASTIC_ARCH, "layers": ELASTIC_LAYERS,
            "from": ELASTIC_FROM, "to": target, "losses": losses,
            "walls_ms": {"from": [m["wall_s"] * 1e3 for m in log_a],
                         "to": [w * 1e3 for w in walls_b]},
            "save_s": save_s, "restore_s": restore_s,
            "checkpoint_bytes": ck_bytes, "loss_rel_err": loss_err,
            "step_share": max(shares), "f32_loss_rel_err": loss32_err,
            "f32_step_share": max(shares32), "witness_loss_rel": loss_wit,
            "witness_step_share": max(witness),
            "phase_s": time.perf_counter() - t_phase}


def graphed_mesh_gate(graphed, eager, graphed_out, eager_out):
    """The graphed mesh server's decode logits against its eager twin's,
    beat by beat (live rows): each within MESH_GRAPH_REL_TOL of the
    eager beat's scale; their tokens equal.  Returns the worst."""
    import numpy as np
    if len(graphed) != len(eager):
        fail(f"mesh: the graphed server ran {len(graphed)} decode beats, "
             f"the eager one {len(eager)}")
    worst = 0.0
    for i, (g, e) in enumerate(zip(graphed, eager)):
        if g.shape != e.shape:
            fail(f"mesh: decode beat {i}: graphed {g.shape}, eager "
                 f"{e.shape}")
        err = float(np.abs(g - e).max() / np.abs(e).max())
        worst = max(worst, err)
        if not err <= MESH_GRAPH_REL_TOL:
            fail(f"mesh: decode beat {i}: the graphed server's logits "
                 f"differ from the eager mesh server's by {err:.3e} of "
                 f"scale")
    if graphed_out != eager_out:
        fail("mesh: the graphed mesh server's tokens differ from the "
             "eager mesh server's")
    return worst


def mesh_phase(dev, card, unsharded_graphed=None):
    """The port's language model over a device mesh: (b) yi-6b at full
    width and depth served by ``CycleServer(cfg, make_axes(mesh))`` on a
    (data 2, model 2) mesh of four LocalTensorMode ranks on this card,
    eagerly, beside the unsharded server on the same weights and
    requests, both timed alone: every prefill layer of the first
    admission and every decode layer of one decode-only beat held to the
    unsharded layer on the mesh's own input (and cache), layer 0's
    inserted cache to the unsharded server's; the end-to-end logits'
    divergence measured beside two witnesses of its cause (the
    unsharded server's torch-kernel twin at bf16; the first prefill in
    float32 on the mesh, unsharded and on the plain attention, each
    mesh layer gated on its own input, the chains measured); flash
    launched per rank on its own heads, its recorded local inputs held
    against the plain version; (a) the dry-run's cells on fake 256- and
    512-rank groups (worker processes, started once the servers' timed
    drains are done); (c) each rank's bytes of parameters, cache and
    decode inputs against the dry-run's ``argument_bytes_per_device``
    for that mesh, config and shape; (b') the same server with
    ``jit=True`` (its decode step one CUDA graph of the four ranks) on
    the same weights and requests, every decode beat's logits within
    MESH_GRAPH_REL_TOL of the eager mesh server's and its tokens equal,
    a decode-only beat profiled beside the eager mesh server's and
    ``unsharded_graphed`` (the lm-yi-6b path's profiled decode-only beat
    log entry and its unprofiled decode-only walls); (d) the elastic shrink (``elastic_phase``), after the
    servers, while the dry-run's workers finish."""
    import numpy as np
    import torch
    import torch.distributed as dist
    print(f"mesh: torch {torch.__version__} [{card}]")
    from torch.distributed._local_tensor import LocalTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import kernels as K
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_axes
    from repro_torch.serving import CycleServer

    t_phase = time.perf_counter()
    cfg = get_config("yi-6b")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in MESH_PROMPTS]
    base = CycleServer(cfg, device=dev, jit=False, seed=SEED, **MESH_SERVER)
    base_log = StepLog(base)
    base_snap = CacheSnapshot(base)
    base_out, base_wall, base_prof = mesh_drain(base, prompts, 4, base_snap)

    dryrun.fake_group(math.prod(MESH_SHAPE))
    recorded = []
    orig_fa = fa.flash_attention

    def recording_fa(q, k, v, **kw):
        if not recorded:    # rank 0's inputs of the first call
            recorded.append(([t._local_tensors[0].clone()
                              for t in (q, k, v)], kw))
        return orig_fa(q, k, v, **kw)
    fa.flash_attention = recording_fa
    K.reset_launches()
    try:
        with LocalTensorMode(math.prod(MESH_SHAPE)):
            mesh = init_device_mesh("cuda", MESH_SHAPE,
                                    mesh_dim_names=("data", "model"))
            t0 = time.perf_counter()
            srv = CycleServer(cfg, make_axes(mesh), device=dev, jit=False,
                              params=base.params, **MESH_SERVER)
            setup_s = time.perf_counter() - t0
            mesh_log = StepLog(srv)
            dec = DecodeLog(srv)
            eager_logits = []
            with LayerLog(cfg.n_layers) as layers:
                mesh_out, mesh_wall, mesh_prof = mesh_drain(
                    srv, prompts, 4, dec, eager_logits)
            launches = dict(K.LAUNCHES)
            n = math.prod(MESH_SHAPE)
            held = [{"params": rank_bytes(srv.params, r),
                     "cache": rank_bytes(srv.cache, r),
                     "inputs": rank_bytes((srv._tokens, srv._positions), r)}
                    for r in range(n)]
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            del srv
            gc.collect()
            torch.cuda.empty_cache()
            # (b') the same server with its decode step captured, on the
            # same weights and requests, timed alone too
            K.reset_launches()
            t0 = time.perf_counter()
            gsrv = CycleServer(cfg, make_axes(mesh), device=dev, jit=True,
                               params=base.params, **MESH_SERVER)
            graph_setup_s = time.perf_counter() - t0
            if not gsrv.graphed or gsrv._graph is None:
                fail("mesh: CycleServer(jit=True) over the mesh is not "
                     "graphed on the card")
            graph_logits = []
            graph_out, graph_wall, graph_prof = mesh_drain(
                gsrv, prompts, 4, beat_logits=graph_logits)
            graph_launches = dict(K.LAUNCHES)
            capture = dict(gsrv.capture_stats)
            del gsrv
    finally:
        fa.flash_attention = orig_fa
    # the dry-run's CPU workers start once both servers' walls are taken
    procs = start_dryrun(ROOT / "build" / "mesh-dryrun")
    print(f"mesh: launches, lm-yi-6b-mesh2x2 path: {json.dumps(launches)}")
    admissions = len(MESH_PROMPTS)
    want_fa = admissions * cfg.n_layers * n
    if launches["flash_attention"] != want_fa:
        fail(f"mesh: flash_attention launched {launches['flash_attention']}"
             f" times, want {admissions} admissions x {cfg.n_layers} layers "
             f"x {n} ranks = {want_fa}")

    # (b) the gates: each prefill layer of the first admission, each
    # decode layer of one decode-only beat, the inserted cache
    layer_err = mesh_layer_gate(
        cfg, base.params, layers.io,
        torch.from_numpy(mesh_log.logits[0]).to(dev),
        min(len(prompts[0]), MESH_SERVER["prefill_len"]) - 1, card)
    decode_err = mesh_decode_gate(cfg, base.params, dec, base_snap.cache,
                                  card)
    del layers, dec
    # then the end-to-end divergence, measured, beside the same
    # requests' divergence between two unsharded servers whose kernels
    # differ (flash vs its plain version) at bf16
    if len(mesh_log.logits) != len(base_log.logits):
        fail(f"mesh: {len(mesh_log.logits)} steps vs the unsharded "
             f"server's {len(base_log.logits)}")
    divergence = step_divergence(mesh_log, base_log)
    sure_steps = 0
    for i, (g, w) in enumerate(zip(mesh_log.logits, base_log.logits)):
        diff = float(np.abs(g - w).max())
        srt = -np.sort(-w, axis=-1)
        sure = srt[:, 0] - srt[:, 1] > diff
        sure_steps += int(sure.sum())
        if (g.argmax(-1)[sure] != w.argmax(-1)[sure]).any():
            fail(f"mesh: step {i} tokens differ where the margin exceeds "
                 f"the logit difference {diff}")
    same_tokens = mesh_out == base_out
    twin = CycleServer(cfg, device=dev, jit=False, params=base.params,
                       **dict(MESH_SERVER, kernels="torch"))
    twin_log = StepLog(twin)
    mesh_drain(twin, prompts, None)
    twin_div = step_divergence(twin_log, base_log)
    del twin, twin_log
    print(f"mesh: lm-yi-6b-mesh2x2: {len(mesh_log.logits)} steps; "
          f"end-to-end logits beside the unsharded server's (measured, "
          f"not gated): first prefill {divergence[0]:.3e}, worst "
          f"{max(divergence):.3e} of scale; the unsharded torch-kernel "
          f"twin beside the same server at bf16: first prefill "
          f"{twin_div[0]:.3e}, worst {max(twin_div):.3e}; {sure_steps} "
          f"rows with a top-2 margin over the difference, their tokens "
          f"equal; tokens {'equal' if same_tokens else 'differ'} "
          f"({sum(map(len, mesh_out))} generated); setup {setup_s:.1f} s; "
          f"peak {peak:.2f} GiB allocated [{card}]")
    graph_err = graphed_mesh_gate(graph_logits, eager_logits, graph_out,
                                  mesh_out)
    if graph_launches["flash_attention"] != want_fa:
        fail(f"mesh: the graphed server's prefills launched flash "
             f"{graph_launches['flash_attention']} times, want {want_fa}")
    print(f"mesh: lm-yi-6b-mesh2x2 graphed (jit=True): graphed "
          f"{capture.get('graphs')} graph, capture "
          f"{capture.get('capture_s', float('nan')):.3f} s, pool "
          f"{capture.get('pool_bytes')} bytes, setup {graph_setup_s:.1f} s; "
          f"{len(graph_logits)} decode beats each within {graph_err:.3e} "
          f"of scale of the eager mesh server's logits (gate "
          f"{MESH_GRAPH_REL_TOL}), tokens equal "
          f"({sum(map(len, graph_out))} generated); drain "
          f"{graph_wall:.3f} s beside the eager mesh server's "
          f"{mesh_wall:.3f} s [{card}]")
    for what, wall, prof in (("unsharded", base_wall, base_prof),
                             ("mesh2x2", mesh_wall, mesh_prof),
                             ("mesh2x2 graphed", graph_wall, graph_prof)):
        med = prof["median_unprofiled_decode_wall_ms"]
        print(f"mesh: {what} server (timed alone): drain {wall:.3f} s; "
              f"decode-only beat 4: wall {prof['wall_ms']:.3f} ms under the "
              f"profiler, busy {prof['busy_ms']:.3f} ms "
              f"({prof['device_ops']} device ops), host ops "
              f"{json.dumps(prof['host_ops'])}; median unprofiled "
              f"decode-only wall {med:.3f} ms, idle "
              f"{1 - prof['busy_ms'] / med:.3f}; top "
              f"{json.dumps(prof['top'])} [{card}]")
    if unsharded_graphed is not None:
        e, walls = unsharded_graphed
        med = statistics.median(walls) if walls else float("nan")
        print(f"mesh: beside them, the unsharded graphed server's profiled "
              f"decode-only beat (lm-yi-6b path, capacity 8): wall "
              f"{e['wall_ms']:.3f} ms under the profiler, busy "
              f"{e['device_busy_ms']:.3f} ms ({e['device_events']} device "
              f"ops), host ops {json.dumps(e['host_ops'])}; median "
              f"unprofiled decode-only wall {med:.3f} ms, idle "
              f"{1 - e['device_busy_ms'] / med:.3f} [{card}]")

    # the kernel on the recorded local inputs (16 query heads over 2 KV
    # heads a rank), against its plain version; not counted
    (q, k, v), kw = recorded[0]
    if (q.shape[2], k.shape[2]) != (cfg.n_heads // MESH_SHAPE[1],
                                    cfg.n_kv // MESH_SHAPE[1]):
        fail(f"mesh: flash's local heads {q.shape[2]} over {k.shape[2]}")
    got = orig_fa(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    err = max_abs_err(got, want)
    rel = float(row_rel_err(got, want).max())
    if not torch.allclose(got.float(), want.float(), rtol=2e-2, atol=1e-1) \
            or rel > FLASH_ROW_REL_TOL:
        fail(f"mesh: flash on rank 0's local inputs: max abs err {err}, "
             f"row-relative {rel}")
    ms = device_ms(lambda: orig_fa(q, k, v, **kw),
                   "flash_attention_wgmma_kernel")[0]
    print(f"mesh: flash_attention on rank 0's local inputs {tuple(q.shape)}"
          f" over {tuple(k.shape)} {kw}: max abs err {err:.3e}, row-relative"
          f" {rel:.3e}, device {ms:.6f} ms [{card}]")
    del recorded, q, k, v, got, want

    # the witness without bf16 rounding: the first prefill in float32
    params = base.params
    del base, base_snap, base_log, mesh_log
    gc.collect()
    torch.cuda.empty_cache()
    f32_err, f32_chain, f32_ends = mesh_f32_witness(cfg, params, prompts[0],
                                                    dev, card)
    del params
    gc.collect()
    K.reset_launches()

    # (c) each rank's bytes against the dry-run's for this mesh and shape
    cpu_mesh = init_device_mesh("cpu", MESH_SHAPE,
                                mesh_dim_names=("data", "model"))
    shape = ShapeSpec("mesh2x2", MESH_SERVER["max_seq"],
                      MESH_SERVER["capacity"], "decode")
    _, _, memory, _ = dryrun.measure(cfg, shape, make_axes(cpu_mesh))
    want_b = memory["argument_bytes_per_device"]
    for r, h in enumerate(held):
        if sum(h.values()) != want_b:
            fail(f"mesh: rank {r} holds {h} = {sum(h.values())} bytes, the "
                 f"dry-run counts {want_b}")
    print(f"mesh: every rank holds {want_b} bytes (params "
          f"{held[0]['params']}, cache {held[0]['cache']}, inputs "
          f"{held[0]['inputs']}) = the dry-run's argument_bytes_per_device")
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()

    # (d) beside the dry-run's last workers (niced): the group it forms
    # goes with it
    elastic = elastic_phase(dev, card)
    print(f"elastic summary: {json.dumps(elastic)}")
    dist.destroy_process_group()
    dryrun.clear_dtensor_caches()
    t0 = time.perf_counter()
    cells = finish_dryrun(procs)
    print(f"mesh: dry-run cells waited {time.perf_counter() - t0:.1f} s; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    return {"flash_launches": launches["flash_attention"]
            + graph_launches["flash_attention"],
            "elastic": elastic,
            "graphed": {"rel_err": graph_err, "drain_s": graph_wall,
                        "setup_s": graph_setup_s, "capture": capture,
                        "beat": graph_prof},
            "layer_rel_err": layer_err, "decode_rel_err": decode_err,
            "f32_layer_rel_err": f32_err, "f32_divergence": f32_chain,
            "f32_logits_divergence": f32_ends, "divergence": divergence,
            "twin_divergence": twin_div, "tokens_equal": same_tokens,
            "rank_bytes": want_b, "cells": len(cells),
            "unsharded": base_prof, "mesh": mesh_prof,
            "drain_s": {"unsharded": base_wall, "mesh": mesh_wall},
            "flash_local": {"err": err, "row_rel": rel, "ms": ms}}


def beat_summary(entries):
    """One kind of beat of one engine: the profiled beat's card busy
    time, device ops and host ops enqueued, beside the median unprofiled
    wall; "not measured" where the trace held no device event."""
    walls = [e["wall_ms"] for e in entries if not e["profiled"]]
    prof = next(e for e in entries if e["profiled"])
    med = statistics.median(walls) if walls else float("nan")
    hops = prof["host_ops"]
    head = (f"host ops {sum(hops.values())} {json.dumps(hops)}, median "
            f"unprofiled wall {med:.3f} ms, ")
    if not prof["device_events"]:
        return head + "card busy not measured (no device event traced)"
    return head + (f"card busy {prof['device_busy_ms']:.3f} ms in "
                   f"{prof['device_events']} device ops (idle share "
                   f"{1 - prof['device_busy_ms'] / med:.3f}; "
                   f"{prof['wall_ms']:.3f} ms wall under the profiler)")


def print_graphed_beside_eager(what, entries):
    print(f"{what}: graphed: "
          + beat_summary([e for e in entries if e["graphed"]])
          + "; eager: "
          + beat_summary([e for e in entries if not e["graphed"]]))


def print_lm_summary(summary, log):
    """The LM path's totals; its admission and decode-only beats, the
    graphed server's beside its eager twin's (whose prefill runs the
    plain attention: only the decode-only beats run the same work)."""
    path = summary["path"]
    beats = [e for e in log if e["path"] == path]
    print(f"{path}:", json.dumps(summary))
    for kind, admitting in (("admission", True), ("decode-only", False)):
        print_graphed_beside_eager(
            f"{kind} beat, {path}",
            [e for e in beats if bool(e["admitted"]) == admitting])
    for kind, r in summary["roofline"].items():
        print(f"roofline: {path} {kind} beat {r['beat']} ({r['admitted']} "
              f"admitted): model FLOPs {r['model_flops']:.6e} in "
              f"{r['card_busy_ms']:.3f} ms of card busy: "
              f"{r['share_of_bf16_peak']:.6f} of the bf16 peak "
              f"({TENSOR_CORE_BF16_FLOPS:.3e} FLOP/s)")


def ptxas_report(lib, names):
    """ptxas's registers, stack frame and spills of the named kernels, as
    the build's ``ptxas.log`` holds them."""
    log = (lib.parent / "ptxas.log").read_text().splitlines()
    for name in names:
        sym = KERNEL_SYMBOLS[name]
        for i, line in enumerate(log):
            if "Compiling entry" in line and sym in line:
                props = "; ".join(x.split("ptxas info    :")[-1].strip()
                                  for x in log[i + 1:i + 4]
                                  if "spill" in x or "registers" in x)
                # a template's instances: <true> / <false>
                inst = ("<true>" if "ILb1E" in line
                        else "<false>" if "ILb0E" in line else "")
                print(f"ptxas, {sym}{inst}: {props}")


@functools.lru_cache(maxsize=None)
def library_sass(lib):
    """{function: its SASS lines} of the kernel library, from the
    toolkit's cuobjdump (None where the toolkit has none)."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[-1].strip()
            out[fn] = []
        elif fn is not None:
            out[fn].append(line)
    return out


def groupby_build_report(lib, dev):
    """shared_groupby as built: its design and device ops a call, the
    co-resident blocks a streaming multiprocessor (at least two launches'
    grids) and the grid at the TPC-W main path's shape, and the float adds
    of its kernel in the SASS, which must all be RED (the result unused),
    none ATOM."""
    from repro_torch import kernels as K
    from repro_torch.kernels import shared_groupby
    per_sm = shared_groupby.blocks_per_sm()
    if per_sm < 2 * shared_groupby.GRID_BLOCKS_PER_SM:
        fail(f"shared_groupby: {per_sm} blocks co-resident a SM, under two "
             f"launches' {shared_groupby.GRID_BLOCKS_PER_SM} each")
    blocks, stripe = shared_groupby.launch_geometry(
        *GROUPBY_MAIN, K.sm_count(dev), per_sm)
    print(f"shared_groupby: {shared_groupby.DESIGN} design, "
          f"{shared_groupby.DEVICE_OPS} device op(s) a call; {per_sm} "
          f"blocks of {shared_groupby.THREADS} co-resident a SM; at (T, W, "
          f"G) = {GROUPBY_MAIN}: {blocks} blocks, stripes of {stripe} "
          f"16-byte units")
    sass = library_sass(lib)
    if sass is None:
        print("cuobjdump not in the toolkit: no SASS check of "
              "shared_groupby's adds")
        return
    lines = [x for fn, body in sass.items()
             if KERNEL_SYMBOLS["shared_groupby"] in fn for x in body]
    red = [x for x in lines if "RED" in x and ".F32" in x]
    atom = [x for x in lines if "ATOM" in x and ".F32" in x]
    ops = sorted({op for x in red + atom for op in x.split()
                  if "RED" in op or "ATOM" in op})
    print(f"SASS, {KERNEL_SYMBOLS['shared_groupby']}: {len(red)} float RED,"
          f" {len(atom)} float ATOM: {ops}")
    if not red or atom:
        fail("shared_groupby: its float adds are not all RED in the SASS")


def flash_build_report(lib):
    """The tensor-core flash-attention kernel as built: ptxas's registers
    and spills and its dynamic shared memory per head dim, and the HGMMA
    (wgmma) instructions of each kernel in the library's SASS, where the
    toolkit has cuobjdump.  Fails if the kernel holds no HGMMA."""
    from repro_torch import kernels as K
    sym = KERNEL_SYMBOLS["flash_attention"]
    log = (lib.parent / "ptxas.log").read_text().splitlines()
    def head_dim(fn):
        return next(D for D in (256, 128, 64) if f"ILi{D}E" in fn)
    for i, line in enumerate(log):
        if "Compiling entry" in line and sym in line:
            D = head_dim(line)
            props = "; ".join(x.split("ptxas info    :")[-1].strip()
                              for x in log[i + 1:i + 4]
                              if "spill" in x or "registers" in x)
            smem = K.library().shareddb_flash_attention_wgmma_smem(D)
            print(f"ptxas, {sym}<{D}>: {props}; {smem} B of dynamic shared "
                  f"memory")
    sass = library_sass(lib)
    if sass is None:
        print("cuobjdump not in the toolkit: no SASS count (ptxas above)")
        return
    counts = {fn: sum("HGMMA" in x for x in lines)
              for fn, lines in sass.items()}
    counts = {fn: n for fn, n in counts.items() if n}
    ours = {f"D {head_dim(f)}": n for f, n in counts.items() if sym in f}
    print(f"SASS: HGMMA instructions in {sym}: {json.dumps(ours)}; in the "
          f"whole library: {sum(counts.values())}")
    if not ours:
        fail(f"{sym} holds no HGMMA instruction")


O_LEG = ROOT / "tests" / "run_torch_fold_differential.py"
O_LEG_TIMEOUT_S = 300
O_LEG_OK = ("stripped-guard probes ok", "fold differential ok [unsharded]",
            "fold differential ok [2-shard mesh]", "FOLD_DIFFERENTIAL_OK")
O_LEG_KERNELS = ("clockscan", "shared_groupby", "fused_delta")
GROUPBY_RETIMES = 5
# (T, W, G) of the steady beat's shared_groupby call at full scale: the
# union cap's rows, three words of queries, the items' groups
GROUPBY_MAIN = (16384, 3, 12048)


def o_leg_phase(card):
    """The port's ``python -O`` fold-differential leg on this card, in a
    process of its own with assert statements stripped: the stripped-guard
    probes, then the fold stream unsharded and on a 2-shard row mesh of
    this card, graphed on the hopper kernels, each ticket held to a cold
    engine of the final template set.  Fails unless it exits 0, prints
    the probes' line and both ok lines, and launched clockscan,
    shared_groupby and fused_delta."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    try:
        out = subprocess.run([sys.executable, "-O", str(O_LEG)], cwd=ROOT,
                             env=env, capture_output=True, text=True,
                             timeout=O_LEG_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"python -O leg: no end within {O_LEG_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    lines = out.stdout.splitlines()
    if out.returncode != 0:
        fail(f"python -O leg exited {out.returncode}: "
             f"{out.stdout[-2000:]} {out.stderr[-2000:]}")
    missing = [want for want in O_LEG_OK if want not in lines]
    if missing:
        fail(f"python -O leg: missing {missing}: {out.stdout[-2000:]}")
    tag = "FOLD_DIFFERENTIAL_LAUNCHES "
    counted = [ln[len(tag):] for ln in lines if ln.startswith(tag)]
    if len(counted) != 1:
        fail(f"python -O leg: {len(counted)} launch lines")
    launches = json.loads(counted[0])
    idle = [k for k in O_LEG_KERNELS if launches.get(k, 0) == 0]
    if idle:
        fail(f"python -O leg: kernels never launched: {idle}")
    for want in O_LEG_OK[:3]:
        print(f"python -O leg: {want}")
    print(f"python -O leg: wall {wall:.3f} s [{card}]")
    print("python -O leg: launches", json.dumps(launches))
    return {"wall_s": wall, "launches": launches}


def groupby_retime(call, row, card):
    """shared_groupby (PERF.md §6 row 2) timed GROUPBY_RETIMES more times
    on its recorded main-path call, beside the kernel row's own timing,
    each as a share of the row's bound, and the previous design's median
    beside them; then its parts: the launch with no rows (the zeroing and
    the barrier) and with no rows and one group (the launch and the
    barrier), beside one ``torch.zeros`` of the packed buffer and of one
    group's.  Fails if a timing's window holds more device ops a call
    than the design's."""
    import torch
    from repro_torch.kernels import shared_groupby
    codes, vals, mask, G = call
    timed = [(row["ms"], row["kernel_launches"], row["window_ops"])] + [
        device_ms(lambda: shared_groupby.shared_groupby(codes, vals, mask, G),
                  KERNEL_SYMBOLS["shared_groupby"])[::2]
        for _ in range(GROUPBY_RETIMES)]
    times, kept, ops = ([t[i] for t in timed] for i in range(3))
    if max(ops) > shared_groupby.DEVICE_OPS:
        fail(f"shared_groupby: device ops a call {ops} in its timings, over "
             f"the {shared_groupby.DESIGN} design's "
             f"{shared_groupby.DEVICE_OPS}")
    med = statistics.median(times)
    shares = [100 * row["bound_ms"] / t for t in times]
    before = PREVIOUS_DESIGN_MS["shared_groupby"]
    print(f"shared_groupby re-timed: device ms {json.dumps(times)}, device "
          f"ops a call {json.dumps(ops)} (kernel events the trace kept a "
          f"call {json.dumps(kept)}); median {med:.6f} ms against the "
          f"bound {row['bound_ms']:.6f} ms ({row['bound_by']}): "
          f"{100 * row['bound_ms'] / med:.1f} % of the bound at the median "
          f"({min(shares):.1f}-{max(shares):.1f} %); the previous design's "
          f"median {before:.6f} ms, {100 * row['bound_ms'] / before:.1f} % "
          f"[{card}]")
    none = (codes[:0], vals[:0], mask[:0])
    Q = mask.shape[1] * 32
    parts = {
        "no rows": (lambda: shared_groupby.shared_groupby(*none, G), 1),
        "no rows, one group":
            (lambda: shared_groupby.shared_groupby(*none, 1), 1),
        "torch.zeros [2, G, Q]":
            (lambda: torch.zeros((2, G, Q), device=mask.device), 0),
        "torch.zeros [2, 1, Q]":
            (lambda: torch.zeros((2, 1, Q), device=mask.device), 0)}
    row["parts_ms"] = {
        what: device_ms(fn, KERNEL_SYMBOLS["shared_groupby"],
                        launches=n)[0] for what, (fn, n) in parts.items()}
    print(f"shared_groupby parts, device ms: {json.dumps(row['parts_ms'])}"
          f" [{card}]")
    row["retimed_ms"] = times
    row["retimed_device_ops"] = ops


def main():
    t_run = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a CUDA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    # before CUDA initialises: the trainer's deterministic algorithms need
    # a fixed cuBLAS workspace (launch/train.py sets it on import)
    import repro_torch.launch.train  # noqa: F401
    from repro_torch import kernels as K
    from repro_torch.configs.shareddb_tpcw import CONFIG
    from repro_torch.core import backends as B

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    print(smi[0])
    dev = torch.device("cuda")
    cap = torch.cuda.get_device_capability(dev)
    if cap < (9, 0):
        fail(f"compute capability {cap}: the kernels are built for sm_90a")
    if B.resolve_backend("auto", dev).name != "hopper":
        fail("kernels='auto' does not resolve to the hopper backend")

    from repro_torch.roofline.analysis import (INT32_LANES_PER_SM,
                                               int32_ops_per_s)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rate = int32_ops_per_s()
    print(f"int32 yardstick: {INT32_LANES_PER_SM} INT32 lanes an SM x {sms} "
          f"SMs x max SM clock {rate / INT32_LANES_PER_SM / sms / 1e6:.0f} "
          f"MHz = {rate:.6e} ops/s (the kernels' bound_ms and core/sla's "
          f"HwModel)")

    t0 = time.perf_counter()
    lib = K.build()
    K.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{lib.relative_to(ROOT)}")
    for line in (lib.parent / "ptxas.log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("ptxas:", line.split("ptxas info    :")[-1].strip())
    ptxas_report(lib, ("partitioned_join", "delta_scan", "bitmask_join",
                       "delta_join"))
    flash_build_report(lib)
    groupby_build_report(lib, dev)

    t0 = time.perf_counter()
    edge_cases(dev)
    print(f"edge cases: all eight kernels agree with their plain versions "
          f"({time.perf_counter() - t0:.1f} s)")

    si, sc = CONFIG.scale_items, CONFIG.scale_customers
    launches = dict.fromkeys(K.LAUNCHES, 0)

    def run_path(name, fn):
        """Drive one path with every launch count set to 0 just before it
        and read just after; each of the path's kernels must launch."""
        K.reset_launches()
        out = fn()
        got = dict(K.LAUNCHES)
        print(f"launches, {name} path:", json.dumps(got),
              "flash_attention by route:",
              json.dumps(K.FLASH_ROUTE_LAUNCHES))
        idle = [k for k in PATH_KERNELS[name] if got[k] == 0]
        if idle:
            fail(f"{name} path: kernels never launched: {idle}")
        for k, n in got.items():
            launches[k] += n
        return out

    fold_rec, chained_rec = Recorder({"join_block"}), Recorder()
    sharded_rec = Recorder()
    kept = {p: {} for p in ("dense", "indexless", "fold", "chained",
                            "sharded")}
    log = run_path("dense", lambda: drive(True, dev, si, sc, "auto",
                                          keep=kept["dense"]))
    log += run_path("indexless", lambda: drive(False, dev, si, sc, "auto",
                                               keep=kept["indexless"]))
    fold = run_path("fold", lambda: fold_path(dev, si, sc, fold_rec,
                                              kept["fold"]))
    log += fold["log"]
    log += run_path("chained",
                    lambda: chained_path(dev, si, sc, fold, chained_rec,
                                         kept["chained"]))
    t0 = time.perf_counter()
    sharded = run_path("sharded",
                       lambda: sharded_path(dev, si, sc, sharded_rec,
                                            kept["sharded"]))
    print(f"sharded path: {time.perf_counter() - t0:.1f} s")
    sharded_kernel_check(sharded_rec.calls)
    log += sharded["log"]
    planlint_phase(kept, fold, smi[0])
    footprints = sla_phase(kept, log, smi[0], si, sc)
    o_leg = o_leg_phase(smi[0])
    del kept
    gc.collect()
    torch.cuda.empty_cache()
    attn, lm_summaries = {}, []
    for name in LM_PATHS:
        print(f"{name}: {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB "
              f"allocated before the path")
        lm_log, summary = run_path(name, lambda: lm_path(dev, name, attn))
        log += lm_log
        lm_summaries.append(summary)
        # the path's servers (a graph holds its server's decode body) go
        # before the next path's weights come
        gc.collect()
        torch.cuda.empty_cache()
    for entry in log:
        print("beat:", json.dumps(entry))
    for path in ("dense", "indexless", "fold", "chained"):
        print_graphed_beside_eager(
            f"steady beat, {path}",
            [e for e in log if e["path"] == path and e["beat"]
             and not e["fold_in_flight"] and not e.get("migration")])
    print_sharded_summary(sharded)
    for summary in lm_summaries:
        print_lm_summary(summary, log)
    building = [e["wall_ms"] for e in fold["log"]
                if e["fold_in_flight"] and e["graphed"]]
    steady = [e["wall_ms"] for e in fold["log"] if e["beat"]
              and e["graphed"] and not e["profiled"]
              and not e["fold_in_flight"] and not e.get("migration")]
    print(f"fold: begin_fold -> build done {fold['build_s'] * 1e3:.1f} ms;"
          f" registration -> committed (end of the migration beat's "
          f"dispatch) {fold['latency_s'] * 1e3:.1f} ms; "
          f"{fold['beats_in_flight']} beats while in flight, "
          f"{len(building)} of them with the build running: median wall "
          f"{statistics.median(building) if building else float('nan'):.3f}"
          f" ms vs {statistics.median(steady):.3f} ms for the path's other "
          f"steady beats")
    print("launches on the main path:", json.dumps(launches))
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")

    # the kernels' recorded inputs: the index-less catalog's beats once
    # more, every op recorded (reseed scans and joins, the last steady
    # beat's groupby and fused_delta); the fold path's block join; the
    # chained path's delta ops
    rec = Recorder()
    B.register_backend(rec.backend(B.get_backend("hopper"),
                                   "hopper-recording"))
    drive(False, dev, si, sc, kernels="hopper-recording", check=False,
          jit=False, recorder=rec,
          armed=("scan", "join_partitioned", "groupby", "fused_delta"))
    calls = dict(rec.calls, **fold_rec.calls, **chained_rec.calls)
    planlint_recorded(calls["fused_delta"], smi[0])
    rows = kernel_rows(calls, launches, attn)
    torch.cuda.synchronize()
    groupby_retime(calls["groupby"][-1],
                   next(r for r in rows if r["name"] == "shared_groupby"),
                   smi[0])
    fd_row = next(r for r in rows if r["name"] == "fused_delta")
    fp = footprints["indexless"]
    print(f"roofline: fused_delta, the index-less steady beat: "
          f"fused_delta_footprint bound {fp['step_time_s'] * 1e3:.6f} ms "
          f"(worst case: every pane at its full span, every dirty set "
          f"full) beside the recorded call's device time "
          f"{fd_row['ms']:.6f} ms and its bound from this run's data "
          f"{fd_row['bound_ms']:.6f} ms (kernel row) [{smi[0]}]")
    for r in rows:
        if r["name"] in PREVIOUS_DESIGN_MS:
            print(f"{r['name']}: device ms {r['ms']:.6f} a set of "
                  f"{r['calls_per_timing']} (kernel {r['kernel_ms']:.6f}, "
                  f"wall {r['wall_ms']:.6f}, {r['device_ops']} device ops a "
                  f"call) against the previous design's "
                  f"{PREVIOUS_DESIGN_MS[r['name']]} (PERF.md §6)")
    del calls, rec, attn, fold_rec, chained_rec, sharded_rec
    gc.collect()
    torch.cuda.empty_cache()
    yi_decode = [e for e in log if e["path"] == "lm-yi-6b" and e["graphed"]
                 and not e["admitted"]]
    meshed = mesh_phase(dev, smi[0], next(
        ((e, [u["wall_ms"] for u in yi_decode if not u["profiled"]])
         for e in yi_decode if e["profiled"]), None))
    print("mesh summary:", json.dumps(meshed))
    for r in rows:      # the mesh phase's launches, counted on their own
        r["mesh_launches"] = meshed["flash_launches"] \
            if r["name"] == "flash_attention" else 0
    # the train phase last: after its profiled 12 000-op step, later
    # torch.profiler sessions in this process traced no device event
    trained = train_phase(dev, smi[0])
    print("train summary:", json.dumps(trained))
    for r in rows:      # no kernel runs on the training paths
        r["training_launches"] = {path: got.get(r["name"], 0)
                                  for path, got in TRAIN_LAUNCHES.items()}
        r["o_leg_launches"] = o_leg["launches"].get(r["name"], 0)
    print(f"python -O leg: phase {o_leg['wall_s']:.1f} s of the whole run's "
          f"{time.perf_counter() - t_run:.1f} s [{smi[0]}]")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
