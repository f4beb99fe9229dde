"""Hand-written CUDA kernels for Hopper (``sm_90a``) behind the ``hopper``
operator backend.

Layout per kernel: ``<name>.py`` holds the wrapper (checks, geometry,
launch) and ``csrc/<name>.cu`` the kernel with a plain C launcher;
``ref.py`` holds the plain PyTorch version of every op.  A wrapper given
CPU tensors computes the plain version; given CUDA tensors it launches
its kernel or raises — there is no fallback.

The kernels are built into ONE shared library by ``nvcc`` at first
use, into ``build/`` at the repository root (git-ignored): one ``nvcc``
per source, all started together, then one link.  The library exports C
functions, loaded with ``ctypes``: no PyTorch headers are compiled, which
keeps the build to seconds.  A source change changes the build's
directory name, so a stale library is never loaded.

Importing this package registers the ``hopper`` backend with
``repro_torch.core.backends``.  Nothing is built or loaded at import.

``LAUNCHES`` counts each wrapper's kernel launches (one per launch, and
nowhere else), so a run can show that its main path went through the
kernels; ``FLASH_ROUTE_LAUNCHES`` splits flash_attention's by kernel;
``COLLECTIVES`` counts a sharded beat's cross-shard collectives
(``core/sharding.all_gather_rows``) the same way; ``reset_launches()``
sets every count to 0.  Inside ``recording()`` a thread's launches count
in a ``LaunchRecord`` instead: a CUDA graph's capture records what each
of its replays launches, and the replay adds that record to the counts
(``add_launches``).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

from repro_torch.core import backends as _backends

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build"
SOURCES = ("clockscan.cu", "shared_groupby.cu", "partitioned_join.cu",
           "fused_delta.cu", "bitmask_join.cu", "flash_attention.cu")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
LIBRARY = "libshareddb_kernels.so"

LAUNCHES = {"clockscan": 0, "shared_groupby": 0, "partitioned_join": 0,
            "fused_delta": 0, "bitmask_join": 0, "delta_scan": 0,
            "delta_join": 0, "flash_attention": 0}
# flash_attention's launches by route (flash_attention.route): which of its
# two kernels ran
FLASH_ROUTE_LAUNCHES = {"wgmma": 0, "simt": 0}
# a sharded beat's collectives by op (core/sharding.py)
COLLECTIVES = {"all_gather_rows": 0}

_lib = None
_lib_lock = threading.Lock()
_recording = threading.local()


def reset_launches() -> None:
    for counts in (LAUNCHES, FLASH_ROUTE_LAUNCHES, COLLECTIVES):
        for k in counts:
            counts[k] = 0


@dataclasses.dataclass
class LaunchRecord:
    """The launches one thread made inside ``recording()``, and the
    device constants they read that no caller owns (``hold``): a graph
    captured there replays those launches and reads those tensors."""
    launches: dict = dataclasses.field(default_factory=dict)
    routes: dict = dataclasses.field(default_factory=dict)
    collectives: dict = dataclasses.field(default_factory=dict)
    held: list = dataclasses.field(default_factory=list)


@contextlib.contextmanager
def recording():
    """Count this thread's launches into a fresh ``LaunchRecord``, not
    into ``LAUNCHES`` / ``FLASH_ROUTE_LAUNCHES``.  A graph capture runs
    in one (its replays add the record back, ``add_launches``), and so
    do its warm-ups, whose launches serve no beat."""
    outer = getattr(_recording, "record", None)
    _recording.record = record = LaunchRecord()
    try:
        yield record
    finally:
        _recording.record = outer


def count_launch(name: str, route: str = None) -> None:
    """One launch of kernel ``name`` (``route``: which of
    flash_attention's kernels), into the thread's record if it has one."""
    record = getattr(_recording, "record", None)
    launches, routes = ((LAUNCHES, FLASH_ROUTE_LAUNCHES) if record is None
                        else (record.launches, record.routes))
    launches[name] = launches.get(name, 0) + 1
    if route is not None:
        routes[route] = routes.get(route, 0) + 1


def count_collective(name: str) -> None:
    """One collective ``name`` of a sharded beat, into the thread's record
    if it has one."""
    record = getattr(_recording, "record", None)
    counts = COLLECTIVES if record is None else record.collectives
    counts[name] = counts.get(name, 0) + 1


def add_launches(record: LaunchRecord) -> None:
    """A replay of a graph captured with ``record``: its launches count."""
    for counts, extra in ((LAUNCHES, record.launches),
                          (FLASH_ROUTE_LAUNCHES, record.routes),
                          (COLLECTIVES, record.collectives)):
        for k, n in extra.items():
            counts[k] = counts.get(k, 0) + n


def hold(t) -> None:
    """Keep ``t`` alive with the recording graph: a cached device
    constant that a launch reads by address (fused_delta's descriptor)
    must outlive every graph that captured the launch."""
    record = getattr(_recording, "record", None)
    if record is not None:
        record.held.append(t)


def _build_tag() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the kernels into ``build/kernels-<tag>/`` (once per source
    tag) and return the shared library's path.

    Each source compiles in its own ``nvcc`` process, all in parallel;
    ``ptxas.log`` beside the library keeps each kernel's register and
    shared-memory report.  Raises RuntimeError with the compiler's output
    when a step fails."""
    out_dir = BUILD_ROOT / f"kernels-{_build_tag()}"
    lib = out_dir / LIBRARY
    if lib.exists():
        return lib
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the hopper kernels")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=BUILD_ROOT))
    try:
        procs = []
        for src in SOURCES:
            obj = tmp / (src + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, obj, p in procs:
            text, _ = p.communicate()
            log.append(f"== {src}\n{text}")
            if p.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / LIBRARY),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (tmp / "ptxas.log").write_text("\n".join(log))
        os.chmod(tmp, 0o755)
        try:
            os.rename(tmp, out_dir)      # atomic: racing builds keep one
        except OSError:
            if not lib.exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.shareddb_error_string.argtypes = [i]
            lib.shareddb_error_string.restype = ctypes.c_char_p
            lib.shareddb_clockscan.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                               i, p]
            lib.shareddb_clockscan.restype = i
            lib.shareddb_groupby.argtypes = [p, p, p, p, i, i, i, i,
                                             ctypes.c_int64, p]
            lib.shareddb_groupby.restype = i
            lib.shareddb_groupby_blocks_per_sm.argtypes = [p]
            lib.shareddb_groupby_blocks_per_sm.restype = i
            lib.shareddb_partitioned_join.argtypes = [
                p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
            lib.shareddb_partitioned_join.restype = i
            lib.shareddb_fused_delta.argtypes = [p, i, i, i, i, p, p]
            lib.shareddb_fused_delta.restype = i
            lib.shareddb_bitmask_join.argtypes = [
                p, p, p, p, p, p, p, i, i, i, i, i, ctypes.c_uint64, p]
            lib.shareddb_bitmask_join.restype = i
            lib.shareddb_delta_scan.argtypes = [p, i, p]
            lib.shareddb_delta_scan.restype = i
            lib.shareddb_delta_join.argtypes = [p, i, p]
            lib.shareddb_delta_join.restype = i
            lib.shareddb_flash_attention.argtypes = [p, p, p, p, i, i, i, i,
                                                     i, i, i, i, i, i, p]
            lib.shareddb_flash_attention.restype = i
            lib.shareddb_flash_attention_wgmma.argtypes = [
                p, p, p, p, i, i, i, i, i, i, i, i, i, p]
            lib.shareddb_flash_attention_wgmma.restype = i
            lib.shareddb_flash_attention_wgmma_smem.argtypes = [i]
            lib.shareddb_flash_attention_wgmma_smem.restype = i
            _lib = lib
    return _lib


def check_launch(code: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error (``cudaGetLastError``)."""
    if code != 0:
        msg = library().shareddb_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


# the persistent grids (clockscan, fused_delta, partitioned_join,
# bitmask_join, delta_scan, delta_join) launch at most this many blocks a
# streaming multiprocessor
BLOCKS_PER_SM = 4


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (the persistent grids
    are sized to it); read once per device, without a sync."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(t):
    """The current CUDA stream of a tensor's device, as a pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require(t, dtype, ndim: int, name: str, device):
    """Validate a kernel argument: dtype, rank, contiguity, device."""
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {ndim}-d {dtype}, got "
                         f"{t.dtype} {tuple(t.shape)} contiguous="
                         f"{t.is_contiguous()}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")


def _register() -> None:
    from repro_torch.kernels import (bitmask_join, clockscan, fused_delta,
                                     partitioned_join, shared_groupby)
    _backends.register_backend(_backends.OperatorBackend(
        name="hopper", scan=clockscan.clockscan,
        join_block=bitmask_join.bitmask_join,
        join_partitioned=partitioned_join.partitioned_join,
        groupby=shared_groupby.shared_groupby,
        scan_delta=fused_delta.delta_scan,
        join_delta=fused_delta.delta_join,
        fused_delta=fused_delta.fused_delta))


_register()
