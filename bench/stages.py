"""Where a beat's time goes, from ``repro_torch``'s own records: runs of one
cell through the benchmark's harness (its set-up, traffic, window and
check), with the engine as the benchmark builds it (mode ``off``) or
with ``trace=True`` (mode ``on``), all in one process.

    python3 bench/stages.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> --modes off,on [--trace 1]

For each seed and mode it prints one JSON line: ``correct``, the
end-to-end metrics, and over the untraced window the beats, the
engine's host ms a beat and the beat period (as ``host_ms_per_beat`` /
``beat_ms`` read them), collect's split into wait, copy-out and route,
the device-to-host copies and the writes held behind the update slots a
beat, the 95th percentile of the writes' admission wait (``admit_time``
- ``submit_time`` of the ``WriteTicket``s), the busy time a beat by CUDA
events around each ``dispatch()``, and in mode ``on`` each stage's
device ms a beat (``last_collect_stats["stage_s"]``), their groups
(``GROUPS``) and the stages' sum over the events' busy time.  With
``--trace 1`` (mode ``on``) it adds the traced window's idle gaps
credited to the innermost host range, the engine's ``repro.*`` ranges
included (``bench/ranges.py``), beside the harness's own breakdown.

Not a measured run: nothing here sets a bound.  Mode ``on`` needs an
engine that takes ``trace``; without one it exits with code 2.
"""
import argparse
import inspect
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
# the build caches inside the checkout, and the repository on sys.path
from run import ROOT  # noqa: E402,F401

# stage groups by name prefix: routing (the Gamma operator, where the
# sorts' top-n and the unsorted routes run their cumsums) is sort + route
GROUPS = {"apply": ("apply",), "scan": ("scan:",), "join": ("join:",),
          "route": ("sort:", "route:"), "groupby": ("groupby:",),
          "commit": ("commit",)}


def group_ms(stage_ms: dict) -> dict:
    """Stage ms a beat summed by ``GROUPS``; {} without stages."""
    if not stage_ms:
        return {}
    return {g: sum(v for k, v in stage_ms.items() if k.startswith(p))
            for g, p in GROUPS.items()}


class Probe:
    """Records what one run's engine did: each dispatch's host stamp and
    CUDA events around it, each collect's ``last_collect_stats``, and
    each write's ``WriteTicket``."""

    def __init__(self):
        self.dispatched = []      # (perf_counter, ev0, ev1) by beat id
        self.collected = []       # last_collect_stats of each collect()
        self.acks = []

    def hook(self, eng) -> None:
        import torch
        cuda = eng.device.type == "cuda"
        dispatch, collect, submit_update = (eng.dispatch, eng.collect,
                                            eng.submit_update)

        def event():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev

        def probed_dispatch():
            t = time.perf_counter()
            ev0 = event() if cuda else None
            dispatch()
            self.dispatched.append((t, ev0, event() if cuda else None))

        def probed_collect():
            out = collect()
            self.collected.append(dict(eng.last_collect_stats))
            return out

        def probed_submit_update(*args):
            w = submit_update(*args)
            if w is not None:
                self.acks.append(w)
            return w
        eng.dispatch, eng.collect = probed_dispatch, probed_collect
        eng.submit_update = probed_submit_update

    def window(self, t0: float, t1: float) -> dict:
        """The records of the beats dispatched in [t0, t1) (a collect
        takes one beat: the harness never collects inside dispatch)."""
        from bench import stats
        win = [s for s in self.collected if s.get("beats")
               and t0 <= self.dispatched[s["beats"][0]][0] < t1]
        n = len(win)
        if not n:
            return {"beats": 0}

        def per_beat(key):
            return sum(s.get(key, 0.0) for s in win) / n

        out = {"beats": n,
               "host_ms_per_beat": 1e3 * sum(
                   s["t_stage_s"] + s["t_dispatch_s"] + s["t_collect_s"]
                   for s in win) / n,
               "beat_ms": (t1 - t0) * 1e3 / n}
        for key in ("t_wait_s", "t_copy_s", "t_route_s", "t_collect_s"):
            if key in win[0]:
                out[key[2:-2] + "_ms"] = per_beat(key) * 1e3
        for key in ("d2h_copies", "writes_held"):
            if key in win[0]:
                out[key + "_per_beat"] = per_beat(key)
        acks = [w for w in self.acks if t0 <= w.submit_time < t1]
        if acks:
            out["write_admit_wait_p95_ms"] = stats.pctl(
                [(w.admit_time - w.submit_time) * 1e3
                 if w.admit_time is not None else stats.FAILED_MS
                 for w in acks], 95)
        stage = {}
        for s in win:
            for k, v in s.get("stage_s", {}).items():
                stage[k] = stage.get(k, 0.0) + v * 1e3 / n
        if stage:
            out["stage_ms"] = stage
            out["stage_group_ms"] = group_ms(stage)
            out["stage_sum_ms"] = sum(stage.values())
        beats = [self.dispatched[s["beats"][0]] for s in win]
        if beats[0][1] is not None:
            ref = beats[0][1]
            beats[-1][2].synchronize()
            spans = [(ref.elapsed_time(a), ref.elapsed_time(b))
                     for _, a, b in beats]
            busy = stats.beats_busy(spans, spans[-1][1]) / n
            out["events_busy_ms_per_beat"] = busy
            if stage and busy:
                out["stage_sum_over_busy"] = out["stage_sum_ms"] / busy
        return out


def traced_engine(executor) -> type:
    """``executor.SharedDBEngine`` built with ``trace=True``."""
    if "trace" not in inspect.signature(executor.SharedDBEngine).parameters:
        raise SystemExit(2)

    class Traced(executor.SharedDBEngine):
        def __init__(self, *args, **kw):
            super().__init__(*args, trace=True, **kw)
    return Traced


def run_one(cell: str, seed: int, seconds: float, mode: str, trace: bool,
            device=None, overrides=None) -> dict:
    """One run of ``cell``; returns the JSON line's object."""
    from bench import harness, ranges
    from bench import trace as tr
    from repro_torch.core import executor
    probe = Probe()
    lines = []
    nested = {}
    real_engine, real_read = executor.SharedDBEngine, tr.read
    if mode == "on":
        executor.SharedDBEngine = traced_engine(executor)

    def read(prof, symbols):
        nested.update(ranges.read(prof))
        return real_read(prof, symbols)
    tr.read = read
    t_start = time.perf_counter()
    try:
        r = harness.run_cell(cell, seed, seconds, trace, t_start,
                             device=device, overrides=overrides,
                             engine_hook=probe.hook, out=lines.append)
    finally:
        executor.SharedDBEngine, tr.read = real_engine, real_read
    setup = next(float(x.split()[2]) for x in lines
                 if x.startswith("setup total_s"))
    t0 = t_start + setup
    out = {"workload": cell, "seed": seed, "mode": mode, "trace": int(trace),
           "correct": r["correct"], "device": r["device"]["kind"],
           "metrics": {k: v["value"] for k, v in r["metrics"].items()},
           "window": probe.window(t0, t0 + seconds)}
    if trace:
        out["idle_gaps"] = r["breakdown"]["idle_gaps"]
        out["idle_gaps_innermost"] = sorted(
            ([n, s] for n, s in nested.items()), key=lambda kv: -kv[1])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--modes", default="off,on")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("stages: no CUDA card", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in args.modes.split(","):
            trace = bool(args.trace) and mode == "on"
            print(json.dumps(run_one(args.workload, seed, args.seconds, mode,
                                     trace)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
