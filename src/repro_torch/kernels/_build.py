"""Build and load the port's CUDA kernels: ``nvcc`` into a plain-C shared
library, loaded with :mod:`ctypes`.

Each ``csrc/<name>.cu`` compiles on its own into
``build/kernels/lib<name>-<hash>.so`` at the root of the checkout, for
``sm_90a`` (Hopper).  The hash covers the source and the flags, so an edited
source builds anew and an unchanged one is loaded as it is.  Nothing is built
when a module is imported: the first launch on a CUDA tensor builds what it
needs, and :func:`build` compiles several libraries at once (one ``nvcc``
process each, all started together).

Every C entry point takes raw device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception with CUDA's own message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

__all__ = ["CSRC", "FLAGS", "build", "build_dir", "check", "library", "logs"]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}  # name -> ctypes.CDLL, each library loaded once per process
_LOGS: dict = {}  # name -> nvcc's output of the build (ptxas registers/spills)


def build_dir() -> pathlib.Path:
    """``build/kernels`` at the root of the checkout (``src/``'s parent)."""
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not pathlib.Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return nvcc


def _target(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{digest}.so"


def build(names) -> dict:
    """Compile every library in ``names`` that is not built yet, all in
    parallel.  Returns ``{name: seconds}`` of the builds that ran; raises
    ``RuntimeError`` with the compiler's output if one fails."""
    todo = {n: _target(n) for n in names if not _target(n).exists()}
    if not todo:
        return {}
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")  # per process
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    seconds, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out_text, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        _LOGS[name] = out_text
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          f"{out_text}")
        else:
            tmp.replace(todo[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def logs() -> dict:
    """nvcc's output of the builds this process ran (``-Xptxas -v``)."""
    return dict(_LOGS)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, kernel: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} ({msg})")
