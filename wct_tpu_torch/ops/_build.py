"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into ``build/wct_tpu_torch/lib<name>_<hash>.so``
at first use and loaded with ``ctypes``. The hash covers the sources
and the flags, so an edited source rebuilds and a stale library is
never loaded. A failed build raises with nvcc's output. Nothing here
runs at import time: the CPU tests import every module on machines
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "wct_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(dep.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Build the named kernels (default: all), one nvcc each, in parallel.

    Returns each library's path; ptxas's register and spill report is
    kept beside it as ``<lib>.log``.
    """
    names = kernel_names() if names is None else names
    out = {n: library_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        lib = todo[n]
        lib.with_name(lib.name + ".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build_all([name])[name]))
        return _libs[name]
