"""Multi-pod dry-run of the port: run every (architecture x shape x mesh)
cell's step on DTensors over a FAKE process group of 256 (``pod16x16``)
or 512 (``pod2x16x16``) ranks, under ``FakeTensorMode`` (nothing is
allocated, nothing is computed), and record per cell

  * ``memory``      -- the largest rank's bytes: arguments, outputs,
                       temporaries, aliased (donated) bytes;
  * ``hlo_flops``   -- FLOPs (key kept from the reference, which counts
                       XLA's HLO FLOPs): each rank's matmul and attention
                       FLOPs from torch's FLOP formulas (``FlopCounterMode``'s
                       registry, plus the flash operator's), x n_chips;
  * ``collectives`` -- what DTensor's redistributions issued, counted by
                       ``CommDebugMode`` (``roofline.parse_collectives``);
  * ``roofline``    -- ``roofline_terms`` on n_chips H100s.

This is ``repro.launch.dryrun``'s counterpart.  The reference lowers with
XLA over 512 forced host devices; the port runs its eager step op by op
over the fake group, so every layer is counted and the counts are exact
at full depth.  The reference's depth-0 / depth-2 lowering is kept only
for ``per_group_flops`` (what one scan group adds).  Everything here is
analytic: no card runs it, and no number it prints is a measured time.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
      --shape train_4k,decode_32k --mesh single --out results/dryrun.json

Results are cached incrementally in the JSON file; a re-run skips
finished cells (``--force`` redoes them).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import time
import traceback
import warnings
import weakref

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.core import pytree
from repro_torch.launch.mesh import make_axes, make_production_mesh
from repro_torch.models import transformer
from repro_torch.models.registry import get_model
from repro_torch.roofline.analysis import (model_flops, parse_collectives,
                                           record_collectives,
                                           roofline_terms)

MESHES = {"pod16x16": False, "pod2x16x16": True}


def fake_group(n_ranks: int) -> None:
    """Make the default process group a fake one of ``n_ranks`` ranks
    (this process is rank 0; collectives move nothing), replacing any.
    DTensor's caches go with a replaced group: a cached sharding names
    the meshes, and so the groups, it was computed on."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n_ranks and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
        clear_dtensor_caches()
    dist.init_process_group("fake", store=FakeStore(), world_size=n_ranks,
                            rank=0)


@contextlib.contextmanager
def simulated_group(n_ranks: int):
    """A process group of ``n_ranks`` ranks simulated in this process: a
    fake default group of that size (``fake_group``) and
    ``LocalTensorMode``, under which every rank's shard is a real tensor
    and every collective moves real numbers.  The one card's stand-in
    for a job re-formed at that size (``runtime/elastic.
    shrink_and_resume``'s ``regroup``)."""
    from torch.distributed._local_tensor import LocalTensorMode
    fake_group(n_ranks)
    with LocalTensorMode(n_ranks):
        yield


def clear_dtensor_caches() -> None:
    """Empty DTensor's caches: its sharding propagation, its per-op
    strategy caches (``functools`` caches in ``torch.distributed``), its
    redistribution planners.  They key on meshes by value, and a mesh
    over a re-created group equals the old one while naming other groups."""
    import gc
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _redistribute
    prop = DTensor._op_dispatcher.sharding_propagator
    for v in vars(prop).values():
        if hasattr(v, "cache_clear"):
            v.cache_clear()
    with warnings.catch_warnings():     # deprecated module attributes
        warnings.simplefilter("ignore")
        for obj in gc.get_objects():
            if isinstance(obj, functools._lru_cache_wrapper) and getattr(
                    obj, "__module__", "").startswith("torch.distributed"):
                obj.cache_clear()
    _redistribute._planner_cache.clear()
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                     None)
    if native is not None:      # the C++ dispatch fast path's cache
        native()


def production_mesh(multi_pod: bool):
    """The production mesh over a fake group of its size (on "cpu": the
    dry-run touches no card)."""
    fake_group(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def _reduced(cfg, n_groups: int):
    """The config whose program has ``n_groups`` groups (same leftovers)."""
    prog = transformer.build_program(cfg)
    kw = {"n_layers": n_groups * len(prog.group) + len(prog.leftover)}
    if cfg.enc_dec:
        kw["n_enc_layers"] = n_groups
    return dataclasses.replace(cfg, **kw)


def local_bytes(t) -> int:
    """Rank 0's bytes of a tensor: a DTensor's local shard (torch.chunk's
    split gives rank 0 the ceiling of every sharded dim, the largest
    shard), else the whole tensor."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t._local_tensor
    return t.numel() * t.element_size()


def _storages(tree) -> set:
    from torch.distributed.tensor import DTensor
    out = set()
    for t in pytree.leaves(tree):
        if isinstance(t, torch.Tensor):
            lt = t._local_tensor if isinstance(t, DTensor) else t
            out.add(lt.untyped_storage()._cdata)
    return out


def _flash_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the flash kernel's softmax sees: query i at
    position i + Sk - Sq; causal keys at or before it, windowed keys
    fewer than ``window`` back."""
    p = np.arange(Sq, dtype=np.int64) + (Sk - Sq)
    hi = np.minimum(Sk, p + 1) if causal else np.full_like(p, Sk)
    lo = np.maximum(0, p - window + 1) if window > 0 else np.zeros_like(p)
    return int(np.maximum(0, hi - lo).sum())


def _register_flash_flops():
    """The flash operator's FLOPs for the counter: 4 per (query, key)
    pair a head (QK^T and PV, a multiply-add each) over D."""
    from torch.utils.flop_counter import flop_registry, register_flop_formula
    op = torch.ops.repro_torch.flash_attention
    if op in flop_registry:
        return

    @register_flop_formula(op)
    def _flops(q_shape, k_shape, v_shape, causal, window, out_shape=None,
               **kwargs):
        B, Sq, H, D = q_shape
        return 4 * B * H * D * _flash_pairs(Sq, k_shape[1], causal, window)


_PROPAGATING = [False]


@contextlib.contextmanager
def _propagating():
    """While it holds, ``_PROPAGATING[0]`` says whether DTensor's sharding
    propagator is computing an op's output metadata, which it does by
    running the op on fake tensors of the global shapes (once per op
    signature; later calls hit its cache)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = "_propagate_tensor_meta_non_cached"
    if not hasattr(ShardingPropagator, name):
        raise RuntimeError(f"this torch's ShardingPropagator has no {name}")
    orig = getattr(ShardingPropagator, name)

    def wrapped(self, *a, **kw):
        was, _PROPAGATING[0] = _PROPAGATING[0], True
        try:
            return orig(self, *a, **kw)
        finally:
            _PROPAGATING[0] = was

    setattr(ShardingPropagator, name, wrapped)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


class LocalAccounting:
    """A dispatch mode that sees each rank's LOCAL ops (a DTensor op is
    let through to desugar first, as ``CommDebugMode`` does) and adds up
    rank 0's FLOPs (torch's FLOP formulas), bytes touched (each op's
    tensor operands and results once; views touch nothing) and live
    bytes: a storage first met as an op's result counts until it is
    freed; ``known`` storages (the arguments) never count.  The ops that
    DTensor's sharding propagation runs on fake tensors of GLOBAL shapes
    (``_propagating``) count nothing."""

    def __new__(cls, known: set):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        class _Mode(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.flops = 0
                self.bytes = 0
                self.live = 0
                self.peak = 0
                self._known = set(known)
                self._sizes = {}

            def _free(self, key):
                self.live -= self._sizes.pop(key, 0)

            def _track(self, t):
                st = t.untyped_storage()
                key = st._cdata
                if key in self._known or key in self._sizes:
                    return
                self._sizes[key] = st.nbytes()
                self.live += st.nbytes()
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, key)

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                if _PROPAGATING[0]:
                    return out      # DTensor's shape propagation
                fn = flop_registry.get(func._overloadpacket)
                if fn is not None:
                    self.flops += int(fn(*args, **kwargs, out_val=out))
                outs = [o for o in pytree.leaves(out)
                        if isinstance(o, torch.Tensor)]
                if not func.is_view:
                    ins = [a for a in pytree.leaves((args, kwargs))
                           if isinstance(a, torch.Tensor)]
                    self.bytes += sum(t.numel() * t.element_size()
                                      for t in ins + outs)
                for o in outs:
                    self._track(o)
                return out

        return _Mode()


def _place(axes, shapes, specs):
    """Fake DTensors of ``shapes`` ((shape, dtype) leaves) on ``specs``."""
    return pytree.dict_map(
        lambda sd, sp: axes.distribute(torch.zeros(sd[0], dtype=sd[1]),
                                       *sp), shapes, specs)


def _args(api, shape):
    """(step arguments, donated ones) of a cell, as fake DTensors."""
    axes = api.axes
    spec_tree, pspecs = api.input_specs(shape), api.input_pspecs(shape)
    params = _place(axes, api.param_shapes(), api.param_specs())
    if shape.kind == "train":
        opt = api.init_opt(params)
        batch = _place(axes, spec_tree["batch"], pspecs["batch"])
        return (params, opt, batch), (params, opt)
    if shape.kind == "prefill":
        return (params, _place(axes, spec_tree["batch"],
                               pspecs["batch"])), ()
    caches = _place(axes, spec_tree["caches"], pspecs["caches"])
    tokens = _place(axes, {"t": spec_tree["tokens"]},
                    {"t": pspecs["tokens"]})["t"]
    positions = _place(axes, {"p": spec_tree["positions"]},
                       {"p": pspecs["positions"]})["p"]
    return (params, caches, tokens, positions), (caches,)


def measure(cfg, shape, axes):
    """Run one cell's step on fake DTensors -> (flops, bytes, memory
    dict, collectives record) for rank 0."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    _register_flash_flops()
    api = get_model(cfg, axes, device="cpu", kernels="hopper")
    with FakeTensorMode(), _propagating():
        args, donated = _args(api, shape)
        arg_bytes = sum(local_bytes(t) for t in pytree.leaves(args))
        alias = sum(local_bytes(t) for t in pytree.leaves(donated))
        acct = LocalAccounting(_storages(args))
        comm = record_collectives()
        with comm, acct:
            out = api.step_fn(shape)(*args)
        known = _storages(args)
        out_bytes = sum(local_bytes(t) for t in pytree.leaves(out)
                        if isinstance(t, torch.Tensor))
        new_out = sum(local_bytes(t) for t in pytree.leaves(out)
                      if isinstance(t, torch.Tensor)
                      and not _storages(t) <= known)
    memory = {"argument_bytes_per_device": arg_bytes,
              "output_bytes_per_device": out_bytes,
              "temp_bytes_per_device": max(0, acct.peak - new_out),
              "alias_bytes_per_device": alias,
              "code_bytes": 0}
    n = axes.mesh.size()
    return acct.flops, acct.bytes, memory, parse_collectives(comm, n)


def analyse_cell(arch: str, shape_name: str, multi_pod: bool,
                 extrapolate: bool = True, overrides: dict = None,
                 fsdp: str = "data") -> dict:
    """One cell's record, in the reference's keys."""
    t0 = time.time()
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    axes = make_axes(production_mesh(multi_pod))
    if fsdp == "none":
        axes = dataclasses.replace(axes, fsdp=None)
    n_chips = 512 if multi_pod else 256
    flops, bytes_acc, memory, coll = measure(cfg, shape, axes)
    flops *= n_chips            # rank 0's count, as XLA's per device
    bytes_acc *= n_chips
    per_group_flops = 0.0
    full_groups = transformer.build_program(cfg).n_groups
    if extrapolate and full_groups >= 2:
        f0 = measure(_reduced(cfg, 0), shape, axes)[0]
        f2 = measure(_reduced(cfg, 2), shape, axes)[0]
        per_group_flops = (f2 - f0) / 2.0 * n_chips
    coll_bytes = coll["total_link_traffic"] * n_chips
    terms = roofline_terms(flops, bytes_acc, coll_bytes, n_chips)
    mf = model_flops(cfg, shape)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "pod2x16x16" if multi_pod else "pod16x16",
        "n_chips": n_chips,
        "status": "ok",
        "memory": memory,
        "hlo_flops": float(flops),
        "hlo_bytes": float(bytes_acc),
        "collective_bytes": coll_bytes,
        "collectives": coll,
        "per_group_flops": per_group_flops,
        "model_flops": mf,
        "useful_flops_ratio": (mf / flops) if flops else 0.0,
        "roofline": terms,
        "wall_s": round(time.time() - t0, 2),
    }


def _coerce(cfg, key: str, value: str):
    """A ``--set`` value in the type of the config field it sets."""
    cur = getattr(cfg, key)
    if isinstance(cur, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(cur, (int, float)):
        return type(cur)(value)
    return value


def run_cells(archs, shapes, meshes, out_path: str, *, force=False,
              extrapolate=True, overrides=None, fsdp="data", tag="",
              log=print) -> dict:
    """Analyse every (mesh x arch x shape) cell into ``out_path`` (JSON,
    written after each cell); cells already ``ok`` or ``skipped`` there
    are kept unless ``force``.  Returns the results."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    results = {}
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            results = json.load(f)
    for mesh_name in meshes:
        multi = MESHES[mesh_name]
        for arch in archs:
            cfg = get_config(arch)
            ov = {k: _coerce(cfg, k, v) for k, v in (overrides or {}).items()}
            for shape_name in shapes:
                key = f"{arch}|{shape_name}|{mesh_name}" + \
                    (f"|{tag}" if tag else "")
                if key in results and results[key].get("status") in (
                        "ok", "skipped") and not force:
                    continue
                if not cfg.supports(shape_name):
                    results[key] = {"arch": arch, "shape": shape_name,
                                    "mesh": mesh_name, "status": "skipped",
                                    "reason": cfg.skip_reason}
                    log(f"SKIP {key}: {cfg.skip_reason[:60]}")
                else:
                    try:
                        rec = analyse_cell(arch, shape_name, multi,
                                           extrapolate=extrapolate,
                                           overrides=ov, fsdp=fsdp)
                        if tag:
                            rec["variant"] = tag
                        results[key] = rec
                        r = rec["roofline"]
                        log(f"OK   {key}: dom={r['dominant']} "
                            f"frac={r['roofline_fraction']:.3f} "
                            f"step={r['step_time_s']:.4f}s "
                            f"({rec['wall_s']}s)")
                    except Exception as e:  # noqa: BLE001 -- a cell's fault
                        results[key] = {"arch": arch, "shape": shape_name,
                                        "mesh": mesh_name, "status": "error",
                                        "error": f"{type(e).__name__}: {e}"}
                        log(f"FAIL {key}: {type(e).__name__}: {e}")
                        traceback.print_exc(limit=4)
                with open(out_path, "w") as f:
                    json.dump(results, f, indent=1)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["both", "single", "multi"])
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--no-extrapolate", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    help="config override key=value (perf variants)")
    ap.add_argument("--fsdp", default="data", choices=["data", "none"],
                    help="none = TP-only weights (inference sharding)")
    ap.add_argument("--tag", default="",
                    help="variant tag appended to result keys")
    args = ap.parse_args(argv)

    overrides = dict(kv.split("=", 1) for kv in args.overrides)
    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"both": ["pod16x16", "pod2x16x16"], "single": ["pod16x16"],
              "multi": ["pod2x16x16"]}[args.mesh]
    results = run_cells(archs, shapes, meshes, args.out, force=args.force,
                        extrapolate=not args.no_extrapolate,
                        overrides=overrides, fsdp=args.fsdp, tag=args.tag,
                        log=lambda m: print(m, flush=True))
    status = [v.get("status") for v in results.values()]
    n_err = status.count("error")
    print(f"done: {status.count('ok')} ok, {status.count('skipped')} "
          f"skipped, {n_err} errors", flush=True)
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
