"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/lib<name>.so`` at the
repository root, at first use, and loaded with ``ctypes``.  Nothing here
runs at import time: importing the package needs no ``nvcc`` and no card.
A source, or a shared header (``csrc/*.cuh``), newer than its library is
rebuilt.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["BUILD_DIR", "CSRC_DIR", "build_all", "load"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# after the source: csrc/hopper.cuh looks up libcuda's
# cuTensorMapEncodeTiled with dlopen / dlsym
LINK_FLAGS = ["-ldl"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "torchdistx_tpu_torch are built from source at first use"
    )


def _paths(name: str):
    return CSRC_DIR / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in [src, *CSRC_DIR.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def _start(name: str) -> subprocess.Popen:
    src, lib = _paths(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src), *LINK_FLAGS]
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def build_all(names: Iterable[str]) -> Dict[str, float]:
    """Build every stale library in ``names`` with one ``nvcc`` each, all
    started together.  Returns seconds per built library; the compiler's
    output (``-Xptxas -v``: registers, shared memory, spills) is kept in
    ``build/torch_kernels/lib<name>.log``."""
    names = [n for n in names if _stale(n)]
    t0 = time.perf_counter()
    procs = {n: _start(n) for n in names}
    seconds, errors = {}, []
    for n, p in procs.items():
        out, _ = p.communicate()
        src, lib = _paths(n)
        (BUILD_DIR / f"lib{n}.log").write_text(out)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        if p.returncode != 0:
            errors.append(f"{src.name}:\n{out}")
            continue
        os.replace(tmp, lib)
        seconds[n] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built first when stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build_all([name])
            lib = ctypes.CDLL(str(_paths(name)[1]))
            _libs[name] = lib
        return lib
