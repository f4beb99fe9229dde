"""Hand-written CUDA kernels for Hopper (``sm_90a``) behind the ``hopper``
operator backend.

Layout per kernel: ``<name>.py`` holds the wrapper (checks, geometry,
launch) and ``csrc/<name>.cu`` the kernel with a plain C launcher;
``ref.py`` holds the plain PyTorch version of every op.  A wrapper given
CPU tensors computes the plain version; given CUDA tensors it launches
its kernel or raises — there is no fallback.

The four kernels are built into ONE shared library by ``nvcc`` at first
use, into ``build/`` at the repository root (git-ignored): one ``nvcc``
per source, all started together, then one link.  The library exports C
functions, loaded with ``ctypes``: no PyTorch headers are compiled, which
keeps the build to seconds.  A source change changes the build's
directory name, so a stale library is never loaded.

Importing this package registers the ``hopper`` backend with
``repro_torch.core.backends``.  Nothing is built or loaded at import.

``LAUNCHES`` counts each wrapper's kernel launches (one per launch, and
nowhere else), so a run can show that its main path went through the
kernels; ``reset_launches()`` sets every count to 0.
"""
from __future__ import annotations

import ctypes
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
           "fused_delta.cu")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
LIBRARY = "libshareddb_kernels.so"

LAUNCHES = {"clockscan": 0, "shared_groupby": 0, "partitioned_join": 0,
            "fused_delta": 0}

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
            lib.shareddb_clockscan.argtypes = [p, p, p, p, p, i, i, i, p]
            lib.shareddb_clockscan.restype = i
            lib.shareddb_groupby.argtypes = [p, p, p, p, p, i, i, i, p]
            lib.shareddb_groupby.restype = i
            lib.shareddb_partitioned_join.argtypes = [
                p, p, p, p, p, p, p, p, i, i, i, i, i, p]
            lib.shareddb_partitioned_join.restype = i
            lib.shareddb_fused_delta.argtypes = [p, i, p, p]
            lib.shareddb_fused_delta.restype = i
            _lib = lib
    return _lib


def check_launch(code: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error (``cudaGetLastError``)."""
    if code != 0:
        msg = library().shareddb_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


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


def _off_path(op: str, row: str):
    def raise_not_ported(*args, **kwargs):
        raise NotImplementedError(
            f"the hopper backend has no {op} kernel yet: it is queued in "
            f"ROADMAP.md, kernel queue item {row}")
    return raise_not_ported


def _register() -> None:
    from repro_torch.kernels import (clockscan, fused_delta,
                                     partitioned_join, shared_groupby)
    _backends.register_backend(_backends.OperatorBackend(
        name="hopper", scan=clockscan.clockscan,
        join_block=_off_path("join_block", "4 (bitmask_join)"),
        join_partitioned=partitioned_join.partitioned_join,
        groupby=shared_groupby.shared_groupby,
        scan_delta=_off_path("scan_delta", "5 (delta_scan)"),
        join_delta=_off_path("join_delta", "5 (delta_join)"),
        fused_delta=fused_delta.fused_delta))


_register()
