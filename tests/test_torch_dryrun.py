"""Port parity, the analytic side of sharding: the models' PartitionSpecs
(parameters, AdamW state, step inputs, decode caches) against the JAX
package's on the production meshes, ``MeshAxes.placements``, the
dry-run (``launch/dryrun.py``) on a fake 256-rank process group, the
collective record (``roofline.parse_collectives``) and the production
mesh over a fake group.

The reference's specs need no devices (``AbstractMesh``); the port's
read only the mesh's names and sizes, and the dry-run runs on fake
tensors, so nothing here allocates a full-size tensor.
"""
import ast
import dataclasses
import math
import pathlib

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro import configs as ref_configs
from repro.models import registry as ref_registry
from repro.models import transformer as ref_tf
from repro.models.common import MeshAxes as RefMeshAxes
from repro.optim import adamw as ref_adamw
from repro_torch import configs
from repro_torch.configs import SHAPES
from repro_torch.core import pytree
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_axes, make_production_mesh
from repro_torch.models import transformer
from repro_torch.models.common import MeshAxes
from repro_torch.models.registry import get_model
from repro_torch.roofline import analysis as roofline

from test_torch_mesh import local_mesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Ops at these sizes gain nothing from intra-op threads; one thread
    keeps this module from oversubscribing the cores that parallel test
    workers share (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _no_group_left():
    """No fake process group left behind for the next module (the
    launchers' tests expect none)."""
    import torch.distributed as dist
    yield
    if dist.is_initialized():
        dist.destroy_process_group()
        dryrun.clear_dtensor_caches()


def _norm(spec):
    """A spec as a tuple, one-axis groups as the axis (JAX's P does so)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _ref_specs(tree):
    return jax.tree.map(lambda s: _norm(tuple(s)), tree,
                        is_leaf=lambda x: isinstance(x, P))


def _port_specs(tree):
    return pytree.dict_map(_norm, tree)


class _SizedMesh:
    """The sizes and names of a production mesh, for the analytic specs
    (which read nothing else of a ``DeviceMesh``)."""

    def __init__(self, shape, names):
        self.shape_, self.mesh_dim_names = shape, names

    def size(self, i):
        return self.shape_[i]


# ---------------------------------------------------------------- the specs
@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_spec_trees_equal_the_reference(arch, multi):
    """param_specs, opt_specs, and input_pspecs (with the decode cache)
    and the prefill cache's specs for every supported shape, leaf for
    leaf, on the production meshes."""
    shape = (2, 16, 16) if multi else (16, 16)
    names = ("pod", "data", "model") if multi else ("data", "model")
    ref = ref_registry.get_model(ref_configs.get_config(arch), RefMeshAxes(
        mesh=AbstractMesh(shape, names),
        dp=names[:-1], fsdp="data", tp="model"))
    api = get_model(configs.get_config(arch), make_axes(
        _SizedMesh(shape, names)), device="cpu")
    ref_params = ref.param_specs()      # traces the reference's init
    assert _port_specs(api.param_specs()) == _ref_specs(ref_params)
    # ref.opt_specs() is opt_state_specs(param_specs()): not traced twice
    assert _port_specs(api.opt_specs()) == _ref_specs(
        ref_adamw.opt_state_specs(ref_params))
    for name, sh in SHAPES.items():
        if not api.cfg.supports(name):
            continue
        want = _ref_specs(ref.input_pspecs(sh))
        assert _port_specs(api.input_pspecs(sh)) == want, name
        _, want_c = ref_tf.cache_struct(
            ref.cfg, sh.global_batch, ref.dec_len(sh.seq_len), ref.axes,
            ctx_len=ref.ctx_len(sh.seq_len))
        got_c = transformer.cache_specs(api.cfg, sh.global_batch, api.axes)
        assert _port_specs(got_c) == _ref_specs(want_c), name


def test_placements_split_pod_before_data():
    """A dim on ("pod", "data") is Shard(d) on both mesh dims; an order
    against the mesh's, or an axis used twice, raises."""
    from torch.distributed.tensor import Replicate, Shard
    axes = make_axes(_SizedMesh((2, 4, 2), ("pod", "data", "model")))
    assert axes.dp == ("pod", "data") and axes.dp_size == 8
    assert axes.tp_size == 2
    assert axes.placements(3, ("pod", "data"), None, "model") == \
        [Shard(0), Shard(0), Shard(2)]
    assert axes.placements(2) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        axes.placements(1, ("data", "pod"))
    with pytest.raises(ValueError, match="twice"):
        axes.placements(2, "model", "model")
    off = MeshAxes()
    x = torch.ones(2)
    assert off.constrain(x, "data") is x and off.distribute(x, "data") is x


# ------------------------------------------------------------- the dry-run
def _ref_record_keys():
    """The keys of the reference dry-run's record and of its "memory",
    read from its source (importing it would set XLA_FLAGS here)."""
    src = pathlib.Path(__file__).parents[1] / "src/repro/launch/dryrun.py"
    for node in ast.walk(ast.parse(src.read_text())):
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "rec":
            keys = [k.value for k in node.value.keys]
            mem = node.value.values[keys.index("memory")]
            return set(keys), {k.value for k in mem.keys}
    raise AssertionError("no rec = {...} in the reference dry-run")


def _independent_arg_bytes(arch, n_layers, shape, mesh_shape, names):
    """Rank 0's argument bytes of a train cell from the REFERENCE's
    param shapes and specs: each dim split over its spec's mesh axes,
    rounded up; AdamW's float32 m and v on the same specs; the int32 step;
    the int32 batch on its input specs."""
    rcfg = dataclasses.replace(ref_configs.get_config(arch),
                               n_layers=n_layers)
    api = ref_registry.get_model(rcfg, RefMeshAxes(
        mesh=AbstractMesh(mesh_shape, names), dp=names[:-1]))
    sizes = dict(zip(names, mesh_shape))

    def local(shape_, spec, itemsize):
        n = itemsize
        for i, d in enumerate(shape_):
            e = spec[i] if i < len(spec) else None
            split = math.prod(sizes[a] for a in (
                e if isinstance(e, tuple) else (e,) if e else ()))
            n *= -(-d // split)
        return n

    shapes = jax.tree.leaves(api.param_shapes())
    specs = jax.tree.leaves(api.param_specs(),
                            is_leaf=lambda x: isinstance(x, P))
    total = sum(local(s.shape, sp, s.dtype.itemsize) + 2 * local(
        s.shape, sp, 4) for s, sp in zip(shapes, specs))
    total += 4                                            # the step
    batch, bspecs = api.input_specs(shape)["batch"], \
        api.input_pspecs(shape)["batch"]
    for k in batch:
        total += local(batch[k].shape, bspecs[k], batch[k].dtype.itemsize)
    return total


def test_dryrun_cell_counts_the_reference_specs_bytes():
    """yi-6b at full width cut to 2 layers, train_4k on a fake 256-rank
    (16, 16) group: status ok, the reference's record keys, the argument
    bytes equal to the independent count, FLOPs and collectives counted."""
    rec = dryrun.analyse_cell("yi-6b", "train_4k", False, extrapolate=False,
                              overrides={"n_layers": 2})
    keys, mem_keys = _ref_record_keys()
    assert set(rec) == keys and set(rec["memory"]) == mem_keys
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    want = _independent_arg_bytes("yi-6b", 2, SHAPES["train_4k"], (16, 16),
                                  ("data", "model"))
    assert rec["memory"]["argument_bytes_per_device"] == want
    assert rec["memory"]["alias_bytes_per_device"] == want - 256 // 16 \
        * 4096 * 4 * 2          # all but the batch (tokens, labels)
    assert rec["hlo_flops"] > rec["model_flops"] / 2 > 0
    c = rec["collectives"]
    assert c["counts"]["all-gather"] > 0 and c["total_link_traffic"] > 0


def test_parse_collectives_counts_what_comm_debug_mode_counts():
    """The recorder's records and CommDebugMode's own counts agree; the
    ring traffic is the reference's arithmetic."""
    w = torch.ones(8, 4)
    with local_mesh((2, 2)) as axes:
        wd = axes.distribute(w, "data", "model")
        rec = roofline.record_collectives()
        with rec:
            axes.constrain(wd)                      # two all-gathers
            (wd.sum(0)).full_tensor()
        got = roofline.parse_collectives(rec, 4)
        counts = {str(k).split(".")[-1]: v
                  for k, v in rec.get_comm_counts().items()}
    assert sum(got["counts"].values()) == sum(counts.values()) > 0
    assert got["counts"]["all-gather"] >= 2
    assert got["total_link_traffic"] == pytest.approx(sum(
        roofline._ring_traffic(k, b, g) for k, b, g in rec.records))


def test_production_mesh_over_a_fake_group():
    """make_production_mesh returns a torch DeviceMesh over a default
    group of 256 (512) ranks, and raises on another size."""
    import torch.distributed as dist
    m = dryrun.production_mesh(False)
    assert tuple(m.shape) == (16, 16) and m.mesh_dim_names == ("data",
                                                               "model")
    m = dryrun.production_mesh(True)
    assert tuple(m.shape) == (2, 16, 16)
    assert make_axes(m).dp == ("pod", "data")
    dist.destroy_process_group()
    dryrun.clear_dtensor_caches()
    with pytest.raises(RuntimeError, match="need 256 devices"):
        make_production_mesh()
