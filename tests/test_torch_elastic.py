"""Port parity, the elastic mesh: checkpoints of sharded trees, the
ladder's shrink-and-resume on a torch ``DeviceMesh`` and the launcher's
checkpoints on a mesh, against the JAX package on the CPU at smoke size.

Meshes of ranks are simulated in this one process
(``launch/dryrun.simulated_group``: a fake process group of the rung's
size and ``LocalTensorMode``, under which every rank's shard is a real
tensor and every collective moves real numbers).  A checkpoint is held
bit for bit: whatever mesh wrote it, it restores onto another mesh,
unsharded and through the reference's ``load_pytree`` with the same
bits.  The shrink (the counterpart of
``test_elastic_relower.py::test_step_relowers_after_mesh_shrink``, whose
sharded cells the installed JAX refuses) is held to the port's unsharded
run and to the reference's unsharded ``train_step`` on the same float32
weights and batches, each leaf within 1e-4 of its norm
(``test_torch_train.py``'s bound: float32 sums split over ranks).
"""
import functools
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.checkpoint import checkpoint as ref_ckpt
from repro.models import registry as ref_registry
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro_torch import configs
from repro_torch.checkpoint import (CheckpointManager, Placed, load_pytree,
                                    save_pytree)
from repro_torch.core import pytree
from repro_torch.core.device import host_tensor
from repro_torch.launch import dryrun, train
from repro_torch.launch.mesh import make_axes
from repro_torch.models import transformer
from repro_torch.models.registry import get_model, params_from_numpy
from repro_torch.runtime.elastic import ElasticMeshManager, shrink_and_resume

CPU = torch.device("cpu")
LEAF_TOL = 1e-4
LOSS_RTOL = 1e-5
LADDER = [(1, 2, 4), (1, 2, 2), (1, 1, 2), (1, 1, 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_no_group_left():
    """One intra-op thread (smoke sizes gain nothing from more), and no
    fake process group left behind for the next module."""
    import torch.distributed as dist
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    if dist.is_initialized():
        dist.destroy_process_group()
        dryrun.clear_dtensor_caches()


def _bits(t) -> np.ndarray:
    """A leaf's stored bits: a tensor's full value (bfloat16 as uint16),
    an array's (ml_dtypes bfloat16 as uint16)."""
    if isinstance(t, torch.Tensor):
        t = host_tensor(t)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    t = np.asarray(t)
    return t.view(np.uint16) if t.dtype == ml_dtypes.bfloat16 else t


def _assert_bits_equal(got, want, what):
    got, want = pytree.leaves(got), pytree.leaves(want)
    assert len(got) == len(want) > 0, what
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)


def _mesh_axes(mgr, rung):
    return make_axes(mgr.make_mesh(rung))


def _filled_state(api):
    """bfloat16 parameters from the seed with float32 moments and a step
    that are not their init's zeros (each written in place, so equal on
    every rank)."""
    params = api.init_params(0)
    opt = api.init_opt(params)
    for p, m, v in zip(pytree.leaves(params), pytree.leaves(opt["m"]),
                       pytree.leaves(opt["v"])):
        m.add_(p.float())
        v.add_(p.float().square())
    opt["step"].fill_(7)
    return params, opt


def test_sharded_checkpoint_restores_on_any_mesh_and_the_reference(tmp_path):
    """A (params, opt) tree saved on a (2, 2) mesh: restored bit-equal onto
    a (1, 2) mesh (placed by the analytic template), unsharded, and by the
    reference's load_pytree; a reference checkpoint restored onto a (2, 2)
    mesh with the template's placements."""
    cfg = configs.smoke_config("yi-6b")
    mgr = ElasticMeshManager(ladder=LADDER)
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    with dryrun.simulated_group(4):
        api = get_model(cfg, _mesh_axes(mgr, (1, 2, 2)), device="cpu")
        state = _filled_state(api)
        save_pytree(state, port, 3, extra={"next_step": 3})
        want = [_bits(t) for t in pytree.leaves(state)]
        # the reference's save of the same values restores onto the mesh
        ref_ckpt.save_pytree(pytree.unflatten(state, [
            w.view(ml_dtypes.bfloat16) if w.dtype == np.uint16 else w
            for w in want]), ref, 5)
        got, _ = load_pytree(api.state_template(), ref, 5)
        for g, t in zip(pytree.leaves(got), pytree.leaves(state)):
            assert g.placements == t.placements
            assert g.device_mesh == t.device_mesh
        _assert_bits_equal(got, want, "reference onto (2, 2)")
    with dryrun.simulated_group(2):
        api = get_model(cfg, _mesh_axes(mgr, (1, 1, 2)), device="cpu")
        template = api.state_template()
        got, man = load_pytree(template, port, 3)
        assert man["extra"] == {"next_step": 3}
        for g, t in zip(pytree.leaves(got), pytree.leaves(template)):
            assert tuple(g.placements) == t.placements
            assert g.device_mesh.mesh.tolist() == [[0, 1]]
        _assert_bits_equal(got, want, "onto (1, 2)")
    got, _ = load_pytree(get_model(cfg, device="cpu").state_template(),
                         port, 3)
    assert all(type(t) is torch.Tensor for t in pytree.leaves(got))
    _assert_bits_equal(got, want, "unsharded")
    rgot, _ = ref_ckpt.load_pytree(pytree.unflatten(
        state, [np.zeros(w.shape, w.dtype) for w in want]), port, 3)
    _assert_bits_equal(rgot, want, "through the reference")
    bad = get_model(cfg, device="cpu").state_template()
    bad[1]["step"] = Placed((2,), torch.int32, CPU)
    with pytest.raises(ValueError, match="shape"):
        load_pytree(bad, port, 3)


@functools.lru_cache(maxsize=None)
def _yi():
    """(port cfg, ref cfg, numpy float32 tree of the port's init)."""
    cfg = configs.smoke_config("yi-6b")
    tree = pytree.dict_map(lambda t: t.numpy(), transformer.init_lm(
        torch.Generator().manual_seed(0), cfg, CPU, torch.float32))
    return cfg, ref_configs.smoke_config("yi-6b"), tree


class _F32Trainer(train.Trainer):
    """The launcher's trainer on the float32 tree of ``_yi``."""

    def init_state(self):
        cfg, _, tree = _yi()
        params = params_from_numpy(tree, cfg, CPU, self.api.axes)
        return params, self.api.init_opt(params)


def test_shrink_and_resume_equals_the_unsharded_run_and_the_reference(
        tmp_path):
    """The ladder's shrink on smoke yi-6b: 1 step on rung (1, 2, 4) (eight
    ranks), checkpoint, shrink_plan to (1, 2, 2) (four), restore into the
    analytic template, 1 step.  Restored bit-equal to what was saved, the
    step counter resumed; the losses and every parameter and moment
    after the second step within 1e-4 of the port's unsharded 2-step run
    and of the reference's unsharded train_step run twice."""
    cfg, rcfg, tree = _yi()
    d = str(tmp_path)
    args = train.parse_args(["--arch", "yi-6b", "--smoke", "--device",
                             "cpu", "--batch", "4", "--seq", "16",
                             "--ckpt", d])
    mgr = ElasticMeshManager(ladder=LADDER)
    assert mgr.select(8, global_batch=4) == (1, 2, 4)
    with shrink_and_resume(
            mgr, (1, 2, 4), 4, CheckpointManager(d), steps=1,
            global_batch=4, regroup=dryrun.simulated_group,
            build=lambda axes: _F32Trainer(args, axes=axes)) as r:
        assert r["plan"]["target"] == (1, 2, 2)
        assert r["plan"]["steps"][1] == "checkpoint (atomic commit)"
        trainer = r["trainer"]
        assert trainer.api.axes.mesh.mesh.tolist() == [[0, 1], [2, 3]]
        state = r["state"]
        saved = np.load(os.path.join(d, "step_00000001", "shard_0.npz"))
        for path, t in pytree.flatten_with_path(state):
            np.testing.assert_array_equal(_bits(t),
                                          saved[pytree.path_key(path)])
        assert int(host_tensor(state[1]["step"])) == 1
        state, m = trainer.step_fn(state, 1)
        assert int(host_tensor(state[1]["step"])) == 2
        got = [host_tensor(t).numpy() for t in pytree.leaves(state)]
    losses = [r["log"][0]["loss"], m["loss"]]

    plain = _F32Trainer(args)
    pstate = plain.init_state()
    rapi = ref_registry.get_model(rcfg, opt_cfg=RefAdamWConfig(lr=args.lr))
    rstate = (jax.tree.map(jnp.asarray, tree), None)
    rstate = (rstate[0], rapi.init_opt(rstate[0]))
    rstep = jax.jit(rapi.train_step)
    for step in range(2):
        pstate, pm = plain.step_fn(pstate, step)
        batch = jax.tree.map(jnp.asarray, plain.pipe.batch_at(step))
        rloss, rp, ro, _ = rstep(*rstate, batch)
        rstate = (rp, ro)
        for loss in (losses[step], pm["loss"]):
            assert abs(loss - float(rloss)) <= LOSS_RTOL * abs(float(rloss))
    wants = {"unsharded": [t.numpy() for t in pytree.leaves(pstate)],
             "reference": [np.asarray(t) for t in jax.tree.leaves(rstate)]}
    for what, want in wants.items():
        assert len(want) == len(got)
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = np.float64(g), np.float64(w)
            assert g.shape == w.shape, (what, i)
            err = np.linalg.norm(g - w)
            assert err <= LEAF_TOL * np.linalg.norm(w), (what, i, err)


def test_launcher_saves_and_resumes_on_a_mesh(tmp_path, monkeypatch):
    """``--mesh`` with ``--ckpt``: the launcher checkpoints DTensor state,
    and a second run restores it into the mesh's analytic template and
    resumes at the saved step (the production mesh stands in as a (1, 2)
    mesh of two simulated ranks; bit-equal restores: the tests above)."""
    mgr = ElasticMeshManager(ladder=LADDER)
    monkeypatch.setattr(train, "make_production_mesh",
                        lambda multi_pod: mgr.make_mesh((1, 1, 2)))
    argv = ["--arch", "yi-6b", "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "8", "--mesh", "single", "--save-every", "1",
            "--ckpt", str(tmp_path)]
    with dryrun.simulated_group(2):
        _, first = train.run(train.Trainer(train.parse_args(
            argv + ["--steps", "1"])))
        state, resumed = train.run(train.Trainer(train.parse_args(
            argv + ["--steps", "2"])))
        assert state[0]["embed"].placements[1].is_shard(0)   # on "model"
        assert int(host_tensor(state[1]["step"])) == 2
    assert [m["step"] for m in first + resumed] == [0, 1]
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
