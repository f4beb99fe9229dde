"""Roofline terms of the port on one NVIDIA H100 (``repro.roofline.
analysis``'s port).

  compute term    = FLOPs / (cards x peak FLOP/s)
  memory term     = bytes / (cards x HBM bytes/s)
  collective term = link traffic / (cards x NVLink bytes/s)

The hardware figures are the H100 SXM's (``HW``, each from NVIDIA's data
sheet; dense rates, no sparsity, at the 700 W power limit), and the
int32 rate of the CUDA cores (``int32_ops_per_s``), at which SharedDB's
predicate compares run.

Collective bytes: the port makes no HLO, so ``collective_schedule``
takes the collectives a beat ran as ``(kind, output bytes)`` records, as
planlint's ``OpRecorder`` sees them (``analysis_static/trace_passes.py``),
and applies the reference's ring arithmetic to them.  Over a DTensor
mesh ``record_collectives`` records what the redistributions issue and
``parse_collectives`` turns that into the same record.
"""
from __future__ import annotations

import functools
import subprocess
from collections import Counter
from typing import Dict, Iterable

# An H100 SXM has 132 SMs at a max SM clock of 1980 MHz.  Each SM issues
# 64 INT32 operations a clock (4 partitions x 16 INT32 lanes) against 128
# FP32 (the 67 TFLOP/s data-sheet rate = 128 x 132 x 1.98e9 x 2 for an
# FMA), so int32 compares run at 64 x 132 x 1.98e9 = 16.73e12 a second.
INT32_LANES_PER_SM = 64
H100_SXM_SMS = 132
H100_SXM_MAX_SM_CLOCK_HZ = 1.98e9

HW = {
    "peak_flops": 989e12,   # bf16 dense tensor-core FLOP/s (data sheet)
    "hbm_bw": 3.35e12,      # HBM3 bytes/s (data sheet)
    "nvlink_bw": 450e9,     # NVLink 4 bytes/s per direction (900 GB/s
    #                         bidirectional, data sheet)
    # int32 ops/s of the CUDA cores, from the data sheet's SM count and
    # clock (see above); ``int32_ops_per_s`` reads the card's own
    "int32_ops": INT32_LANES_PER_SM * H100_SXM_SMS * H100_SXM_MAX_SM_CLOCK_HZ,
}

# the port's collective op, as the reference's HLO names its kind
_KIND = {"all_gather_rows": "all-gather"}


@functools.lru_cache(maxsize=None)
def int32_ops_per_s() -> float:
    """int32 operations a second of the CUDA cores: 64 lanes an SM times
    the SMs times the max SM clock.  With a CUDA card present, its own SM
    count (``torch.cuda.get_device_properties``) and max SM clock
    (``nvidia-smi --query-gpu=clocks.max.sm``); else, or where
    ``nvidia-smi`` gives no clock, the H100 SXM's data-sheet figures
    (``HW["int32_ops"]``).  Read once a process."""
    import torch
    if not torch.cuda.is_available():
        return HW["int32_ops"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, check=True, timeout=60).stdout
        clock_hz = float(out.split()[0]) * 1e6
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        clock_hz = H100_SXM_MAX_SM_CLOCK_HZ
    return INT32_LANES_PER_SM * sms * clock_hz


def _ring_traffic(kind: str, out_bytes: int, gs: int) -> float:
    """Bytes crossing each device's link for one ring execution (the
    reference's arithmetic).  ``out_bytes`` is one device's output: the
    gathered tensor of an all-gather, the full partial of an all-reduce,
    the local shard of a reduce-scatter."""
    if gs <= 1:
        return 0.0
    if kind == "all-gather":
        return out_bytes * (gs - 1) / gs
    if kind == "all-reduce":
        return 2.0 * out_bytes * (gs - 1) / gs
    if kind == "reduce-scatter":
        return float(out_bytes * (gs - 1))
    if kind == "all-to-all":
        return out_bytes * (gs - 1) / gs
    return float(out_bytes)  # collective-permute


def collective_schedule(records: Iterable, group_size: int) -> Dict:
    """The reference's ``parse_collectives`` dict over recorded
    collectives: per-kind output bytes, counts and per-link ring traffic.
    ``records``: ``(kind, output bytes)`` pairs, or ``(kind, output bytes,
    group size)`` triples where a collective's group is not
    ``group_size``; ``kind`` is the port's op name (``all_gather_rows``)
    or the reference's HLO kind."""
    per_kind, counts, traffic = Counter(), Counter(), Counter()
    for rec in records:
        name, out_bytes = rec[0], rec[1]
        gs = rec[2] if len(rec) > 2 else group_size
        kind = _KIND.get(name, name)
        per_kind[kind] += out_bytes
        counts[kind] += 1
        traffic[kind] += _ring_traffic(kind, out_bytes, gs)
    return {"bytes_by_kind": dict(per_kind),
            "counts": dict(counts),
            "link_traffic_by_kind": {k: float(v) for k, v in traffic.items()},
            "total_bytes": sum(per_kind.values()),
            "total_link_traffic": float(sum(traffic.values()))}


# the functional collectives that DTensor's redistributions issue, as the
# reference's HLO names their kinds
_COMM_KIND = {"all_gather_into_tensor": "all-gather",
              "all_gather_into_tensor_coalesced": "all-gather",
              "reduce_scatter_tensor": "reduce-scatter",
              "reduce_scatter_tensor_coalesced": "reduce-scatter",
              "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
              "all_to_all_single": "all-to-all"}


def record_collectives():
    """A ``CommDebugMode`` (``torch.distributed.tensor.debug``) that also
    keeps, in ``.records``, one ``(kind, output bytes, group size)``
    triple per collective it counts: the bytes of one rank's result (the
    gathered tensor, the reduced tensor, the scattered shard), the group
    from the op's own arguments.  Use it as a context around a step, then
    ``parse_collectives`` it."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    class _Recorder(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.records = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented or isinstance(
                    func, torch._ops.HigherOrderOperator):
                return out
            kind = _COMM_KIND.get(func._overloadpacket.__name__)
            if kind is not None:
                self.records.append((kind, _out_bytes(out),
                                     _group_size(args, kwargs)))
            return out

    return _Recorder()


def _out_bytes(out) -> int:
    if isinstance(out, (list, tuple)):
        return sum(_out_bytes(o) for o in out)
    return out.numel() * out.element_size()


def _group_size(args, kwargs) -> int:
    """A functional collective's group size: its group name (the last
    string argument; a reduce op is a string too) resolved."""
    import torch.distributed.distributed_c10d as c10d
    for a in reversed(list(args) + list((kwargs or {}).values())):
        if isinstance(a, str):
            return c10d._resolve_process_group(a).size()
    raise ValueError("collective without a group name")


def parse_collectives(recorder, default_group: int = 256) -> Dict:
    """The reference's ``parse_collectives`` record (per-kind bytes,
    counts, per-link ring traffic, totals) from ``record_collectives``'s
    recorder, which counts what DTensor really issued; its counts equal
    the ``CommDebugMode``'s own (``get_comm_counts``)."""
    return collective_schedule(recorder.records, default_group)


def roofline_terms(flops: float, bytes_accessed: float,
                   collective_bytes: float, n_chips: int,
                   ops_per_s: float = None) -> Dict:
    """flops / bytes_accessed are GLOBAL (summed over cards);
    collective_bytes is global link traffic (per-link traffic x cards),
    so collective_bytes / (cards x link bytes/s) is the per-link time.
    ``ops_per_s``: the rate ``flops`` run at (default the bf16 peak)."""
    peak = HW["peak_flops"] if ops_per_s is None else ops_per_s
    t_comp = flops / (n_chips * peak)
    t_mem = bytes_accessed / (n_chips * HW["hbm_bw"])
    t_coll = collective_bytes / (n_chips * HW["nvlink_bw"])
    terms = {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(t_comp, t_mem, t_coll)
    terms.update(
        dominant=dom.replace("_s", ""),
        step_time_s=bound,
        # fraction of the roofline-limited time spent doing useful compute
        roofline_fraction=(t_comp / bound) if bound > 0 else 0.0,
    )
    return terms


def fused_delta_footprint(lowered, shards: int = 1) -> Dict:
    """Analytic per-beat footprint of the fused delta kernel, from the
    port's lowered plan (the reference's counts, stage for stage).

    Worst case: every stage's admission pane at its full ``delta_words``
    span and every dirty set at ``dirty_cap``.  Three phases:

      pane   — re-admit ALL T rows against the A-word changed pane:
               reads cols [C,T] + pane bounds [C, 32A]x2, read-merges
               the [T, A] carry slice; 2*T*C*32A compares.
      dirty  — re-scan the D dirty rows against the FULL Q-slot window:
               reads [C,D] gathered cols + [C,Q] bounds x2, scatters
               [D, Q/32] words; 2*D*C*Q compares.
      probe  — each dirty spine row probes ONE bucket of width B:
               reads D keys + [D,B] bucket keys/rows, scatters D rids;
               2*D*B compares.

    ``shards`` divides the row-proportional terms (T and D are
    shard-local under the row mesh; probe sides are mirrored).  The int
    ops are timed at the CUDA cores' int32 rate (``HW["int32_ops"]``):
    no compare runs on the tensor cores.  ``step_time_s`` is the larger
    of the bytes' and the int ops' times, on a card a shard."""
    schemas = lowered.plan.catalog.schemas
    bytes_total, iops_total, per_stage = 0.0, 0.0, []
    for st in lowered.scans:
        if not st.cols or not st.covered.any():
            continue
        C, Q, A = len(st.cols), st.q_window, st.delta_words
        T = -(-schemas[st.table].capacity // shards)
        D = min(schemas[st.table].dirty_cap, T)
        b = (T * C * 4 + 2 * C * A * 32 * 4 + 2 * T * A * 4
             + D * C * 4 + 2 * C * Q * 4 + D * (Q // 32) * 8)
        i = 2.0 * T * C * A * 32 + 2.0 * D * C * Q
        per_stage.append({"stage": f"scan:{st.table}", "bytes": b,
                          "int_ops": i})
        bytes_total, iops_total = bytes_total + b, iops_total + i
    for j in lowered.joins:
        if j.kind == "gather":
            continue
        D = min(schemas[j.spine].dirty_cap,
                -(-schemas[j.spine].capacity // shards))
        B = j.bucket_cap if j.kind == "partitioned" \
            else schemas[j.pk_table].capacity
        b = D * 4 + D * B * 8 + D * 8
        i = 2.0 * D * B
        per_stage.append({"stage": f"probe:{j.spine}->{j.pk_table}",
                          "bytes": b, "int_ops": i})
        bytes_total, iops_total = bytes_total + b, iops_total + i
    terms = roofline_terms(iops_total, bytes_total, 0.0, max(shards, 1),
                           ops_per_s=HW["int32_ops"])
    return {"per_stage": per_stage, "bytes": float(bytes_total),
            "int_ops": float(iops_total),
            "arith_intensity": iops_total / max(bytes_total, 1.0),
            "dominant": terms["dominant"],
            "roofline_fraction": terms["roofline_fraction"],
            "step_time_s": terms["step_time_s"]}


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train, 2*N*D inference (D = tokens).

    N counts active parameters (MoE: the routed top-k and the shared
    experts only) and excludes the input-embedding gather (not a matmul);
    the unembedding projection IS a matmul and stays counted (for tied
    embeddings the single table is the unembedding matmul, so nothing is
    subtracted)."""
    n_active = cfg.active_param_count()
    if not cfg.tie_embeddings:
        n_active -= cfg.vocab_padded() * cfg.d_model  # gather-only table
    if shape.kind == "train":
        tokens = shape.global_batch * (
            shape.seq_len // cfg.dec_ratio if cfg.enc_dec else shape.seq_len)
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * (
            shape.seq_len // cfg.dec_ratio if cfg.enc_dec else shape.seq_len)
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # one token per sequence
