"""Port parity and behaviour, the training substrate: the data pipeline,
checkpoints, the fault-tolerant loop, heartbeats, the elastic mesh ladder
and the train launcher (``repro_torch.data`` / ``checkpoint`` /
``runtime`` / ``launch.train``), mirroring tests/test_substrate.py,
tests/test_elastic_relower.py and tests/test_launchers.py on the CPU.

Held against the JAX package: ``TokenPipeline.batch_at`` bit for bit
(frames, vision and host sharding too); checkpoints read across the two
packages with equal bits, keys, shapes, dtype strings (bfloat16
included) and crcs; ``ElasticMeshManager.select`` / ``shrink_plan`` over
1..600 chips and four batch sizes, and its rung validation.
"""
import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import TokenPipeline as RefTokenPipeline
from repro.runtime.elastic import ElasticMeshManager as RefElastic
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.core import pytree
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import train
from repro_torch.runtime import ElasticMeshManager, FaultTolerantLoop
from repro_torch.runtime.elastic import DEFAULT_LADDER
from repro_torch.runtime.fault_tolerance import HeartbeatBoard, StragglerPolicy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke sizes gain nothing from intra-op threads; one thread keeps
    this module from oversubscribing the cores that parallel test workers
    share (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------- data
@pytest.mark.parametrize("kw", [
    dict(vocab=1000, seq_len=32, global_batch=8, seed=1),
    dict(vocab=256, seq_len=16, global_batch=4, seed=7, frames_dim=12,
         frames_len=48),
    dict(vocab=512, seq_len=8, global_batch=6, seed=2, vision_tokens=5,
         vision_dim=10)])
def test_batch_at_equals_the_reference_bit_for_bit(kw):
    hosts = 2 if kw["global_batch"] % 2 == 0 else 1
    for host in range(hosts):
        got = TokenPipeline(DataConfig(**kw), host_id=host, n_hosts=hosts)
        want = RefTokenPipeline(RefDataConfig(**kw), host_id=host,
                                n_hosts=hosts)
        for step in (0, 5, 123):
            a, b = got.batch_at(step), want.batch_at(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k], b[k])
    h0 = TokenPipeline(DataConfig(**kw), 0, 2).batch_at(0)["tokens"]
    h1 = TokenPipeline(DataConfig(**kw), 1, 2).batch_at(0)["tokens"]
    assert h0.shape[0] == kw["global_batch"] // 2
    assert not (h0 == h1).all()


# ---------------------------------------------------------------- checkpoint
def _trees(seed=0):
    """A (params, opt) tree as the trainer keeps it (bf16 parameters,
    float32 moments, an int32 step), in torch and as the reference's
    numpy / ml_dtypes leaves."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((3, 4, 5)).astype(np.float32)
    e = rng.standard_normal((7, 4)).astype(np.float32)
    m = rng.standard_normal((3, 4, 5)).astype(np.float32)
    params = {"g0": {"attn": {"wq": torch.from_numpy(w).bfloat16()}},
              "embed": torch.from_numpy(e).bfloat16()}
    opt = {"m": {"g0": {"attn": {"wq": torch.from_numpy(m)}},
                 "embed": torch.zeros(7, 4)},
           "v": {"g0": {"attn": {"wq": torch.from_numpy(m * m)}},
                 "embed": torch.ones(7, 4)},
           "step": torch.tensor(12, dtype=torch.int32)}
    ref = ({"g0": {"attn": {"wq": w.astype(ml_dtypes.bfloat16)}},
            "embed": e.astype(ml_dtypes.bfloat16)},
           {"m": {"g0": {"attn": {"wq": m}}, "embed": np.zeros((7, 4),
                                                              np.float32)},
            "v": {"g0": {"attn": {"wq": m * m}},
                  "embed": np.ones((7, 4), np.float32)},
            "step": np.int32(12)})
    return (params, opt), ref


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_checkpoints_read_across_the_two_packages(tmp_path):
    """The port's save read by the reference's load_pytree and the
    reference's save read by the port's: same bits, and manifests with
    the same leaf keys ("0/g0/attn/wq"), shapes, dtype strings and
    crcs."""
    mine, ref = _trees()
    p_mine = save_pytree(mine, str(tmp_path / "port"), 7,
                         extra={"next_step": 7})
    p_ref = ref_ckpt.save_pytree(ref, str(tmp_path / "ref"), 7,
                                 extra={"next_step": 7})
    m_mine, m_ref = _manifest(p_mine), _manifest(p_ref)
    assert m_mine == m_ref
    assert "0/g0/attn/wq" in m_mine["leaves"] and "1/step" in m_mine["leaves"]
    assert m_mine["leaves"]["0/embed"]["dtype"] == "bfloat16"
    got_ref, _ = ref_ckpt.load_pytree(ref, str(tmp_path / "port"), 7)
    got_mine, man = load_pytree(mine, str(tmp_path / "ref"), 7)
    assert man["extra"] == {"next_step": 7}
    for a, b in zip(pytree.leaves(mine), jax.tree.leaves(got_ref)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    for a, b in zip(pytree.leaves(mine), pytree.leaves(got_mine)):
        assert a.dtype == b.dtype and a.device == b.device
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert isinstance(got_mine, tuple) and got_mine[1]["step"].dtype \
        == torch.int32


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 3), dtype=torch.int32)},
            "d": [torch.zeros(2, dtype=torch.bfloat16), (torch.ones(1),)]}
    for step in (10, 20, 30):
        mgr.save(tree, step, extra={"next_step": step})
    assert mgr.latest_step() == 30
    got, manifest = mgr.restore(tree, 30)
    assert torch.equal(got["a"], tree["a"])
    assert torch.equal(got["b"]["c"], tree["b"]["c"])
    assert got["d"][0].dtype == torch.bfloat16
    assert isinstance(got["d"], list) and isinstance(got["d"][1], tuple)
    assert manifest["extra"]["next_step"] == 30
    # keep=2 garbage-collected step 10
    assert not os.path.isdir(tmp_path / "step_00000010")
    # restored onto the template's dtype
    as_f64, _ = mgr.restore({**tree, "a": tree["a"].double()}, 20)
    assert as_f64["a"].dtype == torch.float64


def test_checkpoint_detects_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.arange(100, dtype=torch.float32)}
    path = mgr.save(tree, 1, extra={"next_step": 1})
    shard = os.path.join(path, "shard_0.npz")
    blob = dict(np.load(shard))
    blob["w"][0] = 999.0
    np.savez(shard, **blob)
    with pytest.raises(IOError, match="corruption"):
        mgr.restore(tree, 1)


def test_checkpoint_ignores_partial_writes(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.zeros(4)}
    mgr.save(tree, 5, extra={"next_step": 5})
    os.makedirs(tmp_path / "step_00000009.tmp")   # simulated crash
    assert mgr.latest_step() == 5
    CheckpointManager(str(tmp_path))              # reopen: gc the .tmp
    assert not os.path.isdir(tmp_path / "step_00000009.tmp")


# ----------------------------------------------------------- fault tolerance
def test_fault_tolerant_loop_restarts_bit_exact(tmp_path):
    """A failure injected mid-run: the loop resumes from the checkpoint
    and ends in the SAME state as an uninterrupted run."""
    def step_fn(state, step):
        return {"x": state["x"] * 1.1 + step}, {"step": step}

    loop1 = FaultTolerantLoop(step_fn, CheckpointManager(str(tmp_path / "a")),
                              save_every=5)
    s1, _ = loop1.run({"x": torch.zeros(2)}, 0, 20)
    loop2 = FaultTolerantLoop(step_fn, CheckpointManager(str(tmp_path / "b")),
                              save_every=5)
    s2, log = loop2.run({"x": torch.zeros(2)}, 0, 20,
                        fail_at={13: RuntimeError("injected node failure")})
    assert loop2.restarts == 1
    assert [m["step"] for m in log] == list(range(13)) + list(range(10, 20))
    assert torch.equal(s1["x"], s2["x"])


def test_fault_before_first_checkpoint_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    loop = FaultTolerantLoop(lambda s, i: (s, {}), mgr, save_every=50)
    with pytest.raises(RuntimeError, match="before first checkpoint"):
        loop.run({"x": torch.zeros(1)}, 0, 10,
                 fail_at={2: RuntimeError("early failure")})


def test_straggler_and_dead_host_detection():
    board = HeartbeatBoard()
    pol = StragglerPolicy(factor=1.5, patience=3)
    for step in range(4):
        for host in range(4):
            dur = 1.0 if host != 2 else 3.0   # host 2 is slow
            board.beat(host, step, dur, now=float(step))
    assert board.stragglers(pol) == [2]
    assert board.dead_hosts(pol, now=100.0) == [0, 1, 2, 3]
    assert board.dead_hosts(pol, now=3.5) == []
    # a host that registered but never beat goes dead too
    board = HeartbeatBoard()
    board.register(0, now=0.0)
    board.register(7, now=0.0)
    board.beat(0, step=0, duration_s=1.0, now=50.0)
    assert board.dead_hosts(StragglerPolicy(dead_after_s=60.0),
                            now=70.0) == [7]


# ------------------------------------------------------------------- elastic
def test_elastic_select_and_shrink_plan_equal_the_reference():
    mine, ref = ElasticMeshManager(), RefElastic()
    assert mine.ladder == ref.ladder == DEFAULT_LADDER
    for chips in range(1, 601):
        for batch in (None, 8, 256, 7):
            try:
                want = ref.select(chips, batch)
            except RuntimeError as e:
                with pytest.raises(RuntimeError, match=str(e)):
                    mine.select(chips, batch)
                continue
            assert mine.select(chips, batch) == want
            assert mine.shrink_plan((2, 16, 16), chips, batch) \
                == ref.shrink_plan((2, 16, 16), chips, batch)
    with pytest.raises(RuntimeError):
        mine.select(0)


def test_elastic_ladder_validated_and_sorted_like_the_reference():
    rungs = [(1, 1, 1), (1, 2, 2), (1, 1, 2)]
    assert ElasticMeshManager(ladder=list(rungs)).ladder \
        == RefElastic(ladder=list(rungs)).ladder == [(1, 2, 2), (1, 1, 2),
                                                     (1, 1, 1)]
    for bad in ([(1, 2)], [(1, 2, 0)], [(1, 2, -2)], [(1, 2.5, 2)]):
        with pytest.raises(ValueError):
            ElasticMeshManager(ladder=bad)
        with pytest.raises(ValueError):
            RefElastic(ladder=bad)


def test_make_mesh_over_alive_devices():
    """The mesh of a rung is a torch DeviceMesh over ranks of the default
    process group (the surviving ranks when given: a dead one never
    enters it), which make_axes takes; too few survivors, or no group at
    all, raise."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch import dryrun
    mgr = ElasticMeshManager(ladder=[(1, 2, 2), (1, 1, 2), (1, 1, 1)])
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"only 0 alive .*cards here: {n}"):
        mgr.make_mesh((1, 1, 1))
    dryrun.fake_group(4)
    try:
        alive = [0, 2, 3]
        mesh = mgr.make_mesh((1, 1, 2), ranks=alive)
        assert isinstance(mesh, DeviceMesh)
        assert mesh.mesh.tolist() == [[0, 2]]
        assert mesh.mesh_dim_names == ("data", "model")
        axes = launch_mesh.make_axes(mesh)
        assert axes.mesh is mesh and axes.dp == ("data",)
        pods = mgr.make_mesh((2, 1, 2))
        assert pods.mesh.shape == (2, 1, 2)
        assert pods.mesh_dim_names == ("pod", "data", "model")
        assert launch_mesh.make_axes(pods).dp == ("pod", "data")
        with pytest.raises(RuntimeError,
                           match="needs 4 devices, only 3 alive"):
            mgr.make_mesh((1, 2, 2), ranks=alive)
        with pytest.raises(RuntimeError, match="only 4 alive"):
            mgr.make_mesh((1, 1, 5))
    finally:
        dist.destroy_process_group()
        dryrun.clear_dtensor_caches()
    with pytest.raises(RuntimeError, match="need 256 devices"):
        launch_mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="need 512 devices"):
        launch_mesh.make_production_mesh(multi_pod=True)


# ------------------------------------------------------------------ launcher
def test_train_driver_loss_improves(tmp_path):
    log = train.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                      "--steps", "14", "--batch", "4", "--seq", "32",
                      "--ckpt", str(tmp_path), "--save-every", "5"])
    losses = [m["loss"] for m in log]
    assert len(losses) == 14
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_train_driver_resumes_from_checkpoint(tmp_path):
    argv = ["--arch", "mamba2-370m", "--smoke", "--device", "cpu",
            "--batch", "4", "--seq", "32", "--ckpt", str(tmp_path),
            "--save-every", "5"]
    train.main(argv + ["--steps", "10"])
    # second invocation resumes from step 10 and continues to 16
    log = train.main(argv + ["--steps", "16"])
    assert log[0]["step"] == 10
    assert log[-1]["step"] == 15


def test_train_driver_mesh_needs_the_production_cards():
    with pytest.raises(RuntimeError, match="need 256 devices"):
        train.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                    "--steps", "1", "--mesh", "single"])


def test_train_run_replays_a_fault_bit_for_bit(tmp_path):
    """The launcher's FaultTolerantLoop with a fault at step 6: steps 4-5
    replayed from the step-4 checkpoint with bit-equal losses, and the
    final state bit-equal to an uninterrupted run's."""
    argv = ["--arch", "mamba2-370m", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--steps", "8"]
    state, log = train.run(
        train.Trainer(train.parse_args(
            argv + ["--ckpt", str(tmp_path), "--save-every", "4"])),
        fail_at={6: RuntimeError("injected failure")})
    plain, plain_log = train.run(train.Trainer(train.parse_args(argv)))
    steps = [m["step"] for m in log]
    assert steps == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7]
    assert [m["loss"] for m in log[4:6]] == [m["loss"] for m in log[6:8]]
    assert [m["loss"] for m in log[6:]] == [m["loss"] for m in plain_log[4:]]
    for a, b in zip(pytree.leaves(state), pytree.leaves(plain)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(state[1]["step"]) == 8
