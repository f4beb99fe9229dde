"""The correctness check drives a whole run of a cell on the CPU, at a
size a test can hold, with the chip's look skipped: a clean run comes
out correct; the control (the reference answering each beat's queries
before that beat's writes) and each fault a one-chip cell can have come
out not correct; and the timed process loads no JAX.  A cell has no
exchange between chips to leave out: every cell runs on one.

The ``cuda`` case runs ``bench/run.py`` itself on the card.

Run with ``pytest bench/tests``."""
import collections
import json
import pathlib
import subprocess
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from bench import harness  # noqa: E402

CELLS = ("tpcw10k-dense.shopping.p80", "tpcw10k-indexless.ordering.pool256")
# a TPC-W of 128 items and 256 customers, served by the plain torch ops
TINY = {"scale_items": 128, "scale_customers": 256, "kernels": "torch",
        "graphed": False, "traffic.warmup_s": 0.3, "traffic.rate_per_s": 150,
        "traffic.clients": 12}


def run(cell, seed=11, hook=None, control=False, seconds=1.0):
    return harness.run_cell(cell, seed, seconds, False, time.perf_counter(),
                            device="cpu", overrides=TINY, engine_hook=hook,
                            control=control, out=lambda line: None)


def wrap_cycles(eng, fn):
    """Put ``fn(out) -> out`` behind every cycle flavour's output
    (state', carry', results)."""
    h = eng._gen
    for f, cycle in list(h.cycles.items()):
        h.cycles[f] = (lambda c: lambda *a: fn(a, c(*a)))(cycle)


def state_unchanged(eng):
    # every beat hands back the state it was given
    wrap_cycles(eng, lambda args, out: (args[0],) + tuple(out[1:]))


def half_batch_left_out(eng):
    admit = eng._admit_updates

    def half(buf):
        q = eng._update_queue
        eng._update_queue = collections.deque(
            w for k, w in enumerate(q) if k % 2 == 0)
        return admit(buf)
    eng._admit_updates = half


def answer_altered(eng):
    def alter(args, out):
        res = out[2]
        rows = res["get_customer"]["rows"].clone()
        rows[0] = rows[0] + (rows[0] >= 0).to(rows.dtype)
        res["get_customer"] = dict(res["get_customer"], rows=rows)
        return out
    wrap_cycles(eng, alter)


@pytest.mark.parametrize("cell", CELLS)
def test_a_clean_run_is_correct_and_the_control_is_not(cell):
    r = run(cell, control=True)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert all(c["limit"] == 0 for c in r["checks"].values())
    # the control, judged by the same checks and limits, is not correct
    ctl = r["control"]
    assert ctl["correct"] is False, ctl["checks"]
    assert {k: c["limit"] for k, c in ctl["checks"].items()} == {
        k: c["limit"] for k, c in r["checks"].items()}
    assert ctl["checks"]["wrong_answers"]["value"] > 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_the_host_from_its_untraced_window(cell):
    r = harness.run_cell(cell, 13, 1.0, True, time.perf_counter(),
                         device="cpu", overrides=TINY, out=lambda line: None)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    part = "open" if "shopping" in cell else "closed"
    # spans, stamps and counters come from the untraced window of the
    # same length as any run's; the CPU has no device trace to read
    assert m[f"beat_ms.{part}"]["value"] > 0
    assert m[f"host_ms_per_beat.{part}"]["value"] > 0
    assert f"torch_ops_ms_per_beat.{part}" not in m
    if part == "open":
        assert m["full_beat_share"]["value"] > 0
        assert m["admit_wait_p95_ms"]["value"] >= 0
    assert "wi_p95_ms" not in m and "wips" not in m
    assert r["device"]["window_s"] > 0 and "breakdown" in r


@pytest.mark.parametrize("fault", [state_unchanged, half_batch_left_out,
                                   answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_on_the_timed_path_is_caught(cell, fault):
    r = run(cell, hook=fault)
    assert not r["correct"], (fault.__name__, r["checks"])


def test_the_timed_process_loads_no_jax():
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "from bench import harness\n"
        "r = harness.run_cell('tpcw10k-dense.shopping.p80', 3, 0.5, False, "
        "time.perf_counter(), device='cpu', overrides=%r, "
        "out=lambda l: None)\n"
        "top = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps([r['correct'], top]))\n"
        % (str(ROOT), str(ROOT / "src"), TINY))
    p = subprocess.run([sys.executable, "-c", "import json\n" + code],
                       capture_output=True, text=True, timeout=600,
                       cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    correct, top = json.loads(p.stdout.strip().splitlines()[-1])
    assert correct
    assert "repro_torch" in top
    assert not set(top) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_run_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         "3000000017", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
