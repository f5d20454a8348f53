"""Device choice and the f32 numerics policy, in one place.

The JAX package runs every f32 conv and matmul at ``Precision.HIGHEST``
(``wct_tpu/ops/convs.py:61``, ``ops/reductions.py:66-69``). PyTorch's
cuDNN default runs f32 convs in TF32, which keeps about three decimal
digits, so the port turns TF32 off for convs and matmuls alike.

``stylize_microbatched`` promises that an image's output does not
depend on the batch it came in (``wct_tpu/models/cascade.py:762-815``).
It runs every request through one fixed batch shape; for that to give
the same bits every time, cuDNN must pick the same deterministic
algorithm for the same shape, hence ``deterministic=True`` and
``benchmark=False``.
"""

from __future__ import annotations

import torch


def set_fp32_numerics() -> None:
    """Full f32 convs and matmuls (no TF32), deterministic cuDNN."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; CUDA unless the caller says CPU.

    Asking for CUDA where there is none raises: the port never falls
    back to the CPU on its own.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU"
        )
    set_fp32_numerics()
    return dev


def cuda_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` on the current CUDA stream, event-timed
    after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def params_device(params: dict) -> torch.device:
    """The device the parameter tree lives on (read off conv1_1)."""
    return params["encoder"]["conv1_1"]["w"].device
