"""Port parity, the SLA model and the roofline terms: ``repro_torch.core
.sla`` and ``repro_torch.roofline`` against ``repro.core.sla`` and
``repro.roofline`` on the CPU.

The port's default hardware is the H100's; here both packages run under
the reference's constants (an explicit ``HwModel(197e12, 819e9)``, the
port's ``HW`` patched to the reference's figures), so every per-node
FLOP and byte count, every footprint term and every derived time must
be equal, exactly where the formulas are the same arithmetic.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import sla as ref_sla
from repro.core.lowering import lower_plan as ref_lower_plan
from repro.roofline import analysis as ref_analysis
from repro.workloads import tpcw as ref_tpcw
from repro_torch import configs, roofline
from repro_torch.analysis_static import trace_passes as tp
from repro_torch.core import sharding, sla
from repro_torch.core.executor import SharedDBEngine
from repro_torch.core.lowering import lower_plan
from repro_torch.roofline import analysis
from repro_torch.workloads import tpcw

SCALE_I, SCALE_C = 128, 256
# the reference's roofline constants, under the port's HW keys
REF_HW = {"peak_flops": ref_analysis.HW["peak_flops"],
          "hbm_bw": ref_analysis.HW["hbm_bw"],
          "nvlink_bw": ref_analysis.HW["ici_bw"],
          "int32_ops": ref_analysis.HW["peak_flops"]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small plans gain nothing from intra-op threads; one thread keeps
    this module from oversubscribing the cores that parallel test workers
    share (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plans(dense):
    return (tpcw.build_tpcw_plan(SCALE_I, SCALE_C, dense_pk_index=dense),
            ref_tpcw.build_tpcw_plan(SCALE_I, SCALE_C, dense_pk_index=dense))


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "indexless"])
def test_cycle_cost_and_provision_equal_the_reference(dense):
    mine, ref = _plans(dense)
    hw, ref_hw = sla.HwModel(197e12, 819e9), ref_sla.HwModel(197e12, 819e9)
    got, want = sla.cycle_cost(mine, hw), ref_sla.cycle_cost(ref, ref_hw)
    assert got == want                  # per-node flops / bytes, exactly
    assert len(got["nodes"]) > 10
    for s in (3.0, 1e-6, 1e-9):         # 1, then many cards
        assert sla.provision(mine, s, hw) == ref_sla.provision(ref, s, ref_hw)
    assert sla.provision(mine, 1e-9, hw)["chips_required"] > 1


def test_hw_model_is_the_h100s():
    """The port's defaults: HBM3 3.35 TB/s, and the cycle's compares at
    the CUDA cores' int32 rate (64 lanes x 132 SMs x 1.98 GHz on the
    data sheet; the card's own where one is present)."""
    hw = sla.HwModel()
    assert hw.bytes_per_s == 3.35e12 == roofline.HW["hbm_bw"]
    assert roofline.HW["int32_ops"] == pytest.approx(16.727e12, rel=1e-4)
    assert roofline.HW["peak_flops"] == 989e12
    assert roofline.HW["nvlink_bw"] == 450e9
    if not torch.cuda.is_available():
        assert hw.flops_per_s == roofline.int32_ops_per_s() == \
            roofline.HW["int32_ops"]
    plan, _ = _plans(False)
    cost = sla.cycle_cost(plan)
    assert cost["worst_cycle_s"] == max(
        cost["total_flops"] / hw.flops_per_s,
        cost["total_bytes"] / hw.bytes_per_s)


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "indexless"])
def test_fused_delta_footprint_equals_the_reference(monkeypatch, dense,
                                                    shards):
    monkeypatch.setattr(analysis, "HW", REF_HW)
    mine, ref = _plans(dense)
    got = analysis.fused_delta_footprint(lower_plan(mine), shards)
    want = ref_analysis.fused_delta_footprint(ref_lower_plan(ref), shards)
    assert got["per_stage"] == want["per_stage"]
    assert any(s["stage"].startswith("probe:") for s in got["per_stage"]) \
        != dense
    for key in ("bytes", "int_ops", "arith_intensity", "dominant",
                "roofline_fraction"):
        assert got[key] == want[key], key
    # under the port's own HW the int ops run at the int32 rate
    monkeypatch.undo()
    h100 = analysis.fused_delta_footprint(lower_plan(mine), shards)
    assert h100["step_time_s"] == max(
        h100["bytes"] / (shards * analysis.HW["hbm_bw"]),
        h100["int_ops"] / (shards * analysis.HW["int32_ops"]))


def test_roofline_terms_equal_the_reference(monkeypatch):
    monkeypatch.setattr(analysis, "HW", REF_HW)
    for args in ((1e15, 1e12, 1e10, 256), (1e12, 1e15, 0, 256),
                 (1e9, 1e6, 1e12, 4), (0.0, 0.0, 0.0, 1)):
        assert analysis.roofline_terms(*args) == \
            ref_analysis.roofline_terms(*args)


def test_model_flops_equals_the_reference():
    for arch in configs.ARCH_IDS:
        for name, shape in configs.SHAPES.items():
            got = roofline.model_flops(configs.get_config(arch), shape)
            want = ref_analysis.model_flops(ref_configs.get_config(arch),
                                            ref_configs.SHAPES[name])
            assert got == want, (arch, name)
    mix = configs.get_config("mixtral-8x22b")       # active params only
    assert roofline.model_flops(mix, configs.SHAPES["train_4k"]) < \
        6 * mix.param_count() * 4096 * 256 * 0.45


HLO_SAMPLE = """
  %all-gather.1 = f32[2048,352]{1,0} all-gather(%x), channel_id=1, replica_groups=[16,16]<=[256], dimensions={0}
  %all-reduce.7 = bf16[128,64]{1,0} all-reduce(%y), channel_id=2, replica_groups=[32,8]<=[256], to_apply=%add
  %reduce-scatter.2 = f32[64,64]{1,0} reduce-scatter(%z), channel_id=3, replica_groups=[16,16]<=[256], dimensions={0}
  %all-to-all.3 = f32[16,16]{1,0} all-to-all(%w), channel_id=4, replica_groups=[1,256]<=[256]
  %collective-permute.9 = u32[8]{0} collective-permute(%v), channel_id=5
  %fusion.1 = f32[10]{0} fusion(%all-gather.1), kind=kLoop
"""


def test_collective_schedule_equals_parse_collectives():
    """The reference's HLO sample (tests/test_plan_and_roofline.py), its
    kinds, output bytes and groups as records: the same dict."""
    records = [("all-gather", 2048 * 352 * 4, 16),
               ("all-reduce", 128 * 64 * 2, 8),
               ("reduce-scatter", 64 * 64 * 4, 16),
               ("all-to-all", 16 * 16 * 4, 256),
               ("collective-permute", 8 * 4)]
    want = ref_analysis.parse_collectives(HLO_SAMPLE, default_group=256)
    assert roofline.collective_schedule(records, 256) == want
    # the port's op is the reference's all-gather
    got = roofline.collective_schedule(
        [("all_gather_rows", 100), ("all-reduce", 8)], 2)
    assert got["counts"] == {"all-gather": 1, "all-reduce": 1}
    assert got["total_link_traffic"] == 100 * 1 / 2 + 2.0 * 8 / 2


def test_reseed_collective_schedule_from_the_recorder():
    """A 2-shard engine's recorded reseed: one all_gather_rows per
    mirrored predicated stage, each one device's output [2 Ts, w] int32,
    half of it crossing each link; the delta beats none."""
    plan = tpcw.build_tpcw_plan(64, 128, dense_pk_index=False)
    data = tpcw.generate_data(np.random.default_rng(0), 64, 128)
    eng = SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS, data,
                         kernels="torch",
                         mesh=sharding.make_row_mesh(2, ["cpu"] * 2))
    eng.submit("get_book", {0: (5, 5)})
    eng.run_until_drained()
    recs = tp.record_beats(eng)
    spec = eng._gen.spec
    mirrored = [st for st in eng._lowered.scans
                if spec.is_mirrored(st.table) and st.cols]
    want = sorted(2 * spec.shard_rows[st.table] * (st.whi - st.wlo) * 4
                  for st in mirrored)
    full = recs["full"].collective_bytes
    assert sorted(b for _, b in full) == want and len(want) == 3
    sched = roofline.collective_schedule(full, 2)
    assert sched["counts"] == {"all-gather": 3}
    assert sched["total_bytes"] == sum(want)
    assert sched["total_link_traffic"] == sum(want) / 2
    assert recs["delta"].collective_bytes == []


def test_sla_and_roofline_load_no_jax():
    code = ("import sys, repro_torch.core.sla, repro_torch.roofline; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.'))); "
            "print(bad); sys.exit(1 if bad else 0)")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=src),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
