"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into ``build/wct_tpu_torch/lib<name>_<hash>.so``
at first use and loaded with ``ctypes``. The hash covers the sources
and the flags, so an edited source rebuilds and a stale library is
never loaded. A failed build raises with nvcc's output. Nothing here
runs at import time: the CPU tests import every module on machines
without ``nvcc``.

``defines`` builds a variant with ``-D`` macros into a library of its
own (``lib<name>_<macros>_<hash>.so``): ``WCT_STAGE_TIMES`` turns on the
junction kernel's stage stamps (``tools/junction_stages.py``); the
normal build has none.
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

_libs: dict[tuple, ctypes.CDLL] = {}
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


def _flags(defines: tuple[str, ...] = ()) -> tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for dep in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(dep.read_bytes())
    tag = "".join(f"_{d.split('=')[0].lower()}" for d in defines)
    return BUILD_DIR / f"lib{name}{tag}_{h.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None, defines: tuple[str, ...] = ()) -> dict[str, Path]:
    """Build the named kernels (default: all), one nvcc each, in parallel,
    with ``-D`` for each of ``defines``.

    Returns each library's path; ptxas's register and spill report is
    kept beside it as ``<lib>.log``.
    """
    names = kernel_names() if names is None else names
    out = {n: library_path(n, defines) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(defines), "-o", str(tmp), str(CSRC / f"{n}.cu")]
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


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built with ``defines``),
    built if needed."""
    key = (name, *defines)
    with _lock:
        if key not in _libs:
            _libs[key] = ctypes.CDLL(str(build_all([name], defines)[name]))
        return _libs[key]


def launch(name: str, lib: str, symbol: str, argtypes: list, args: tuple, device,
           defines: tuple[str, ...] = ()) -> None:
    """Call ``symbol(*args, stream)`` of ``csrc/<lib>.cu`` (built with
    ``defines``) on ``device``'s current stream; raise if the launch is
    refused. Does not synchronise."""
    import torch

    fn = getattr(load(lib, defines), symbol)
    fn.argtypes = argtypes + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
