"""Port parity, host IR: the PyTorch package's plan, lowering IR and
workload equal the JAX package's field for field, and importing the port
pulls in neither JAX nor the JAX package."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.core.executor import _measure_key_stats as ref_key_stats
from repro.core.lowering import lower_plan as ref_lower_plan
from repro.workloads import tpcw as ref_tpcw
from repro_torch.core.executor import _measure_key_stats
from repro_torch.core.lowering import lower_plan
from repro_torch.workloads import tpcw

SCALE_I, SCALE_C = 128, 256


def _assert_same(a, b, path):
    """Deep equality of IR values across the two packages: dataclasses
    by field (their classes differ), arrays by dtype and value."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            if f.name in ("plan", "catalog"):
                continue
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("dense_pk_index", [True, False])
@pytest.mark.parametrize("measured", [False, True])
def test_lowered_plan_equal_field_for_field(dense_pk_index, measured):
    data = tpcw.generate_data(np.random.default_rng(3), SCALE_I, SCALE_C)
    plan = tpcw.build_tpcw_plan(SCALE_I, SCALE_C,
                                dense_pk_index=dense_pk_index)
    ref_plan = ref_tpcw.build_tpcw_plan(SCALE_I, SCALE_C,
                                        dense_pk_index=dense_pk_index)
    stats = _measure_key_stats(plan, data) if measured else None
    ref_stats = ref_key_stats(ref_plan, data) if measured else None
    assert stats == ref_stats
    low, ref_low = lower_plan(plan, stats), ref_lower_plan(ref_plan,
                                                           ref_stats)
    _assert_same(low, ref_low, "lowered")
    # the compiled plan and the catalog too
    _assert_same(plan, ref_plan, "plan")
    assert plan.catalog.schemas.keys() == ref_plan.catalog.schemas.keys()
    for name, s in plan.catalog.schemas.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(
            ref_plan.catalog.schemas[name]), name
    for names in (["get_book", "search_author"], ["best_sellers"]):
        np.testing.assert_array_equal(plan.sub_mask(names),
                                      ref_plan.sub_mask(names))


def test_generate_data_and_workload_equal():
    a = tpcw.generate_data(np.random.default_rng(11), SCALE_I, SCALE_C)
    b = ref_tpcw.generate_data(np.random.default_rng(11), SCALE_I, SCALE_C)
    _assert_same(a, b, "data")
    ga = tpcw.WorkloadGenerator(np.random.default_rng(5), SCALE_I, SCALE_C)
    gb = ref_tpcw.WorkloadGenerator(np.random.default_rng(5), SCALE_I,
                                    SCALE_C)
    for mix in ("shopping", "ordering"):
        for x, y in zip(ga.sample_mix(mix, 60), gb.sample_mix(mix, 60)):
            assert (x.kind, x.queries, x.updates) == \
                (y.kind, y.queries, y.updates)
    assert tpcw.MIXES == ref_tpcw.MIXES
    assert dataclasses.asdict(tpcw.DEFAULT_UPDATE_SLOTS) == \
        dataclasses.asdict(ref_tpcw.DEFAULT_UPDATE_SLOTS)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of repro_torch imports in a fresh interpreter with
    jax and repro left out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
