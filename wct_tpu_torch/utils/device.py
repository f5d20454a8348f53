"""Device choice and the f32 and bf16 numerics policies, in one place.

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

Under ``compute_dtype="bfloat16"`` the JAX package's products are exact
bf16 × bf16 with an f32 accumulator (``preferred_element_type``). cuBLAS
may by default add the partial sums of a split-K bf16 product in bf16;
over the N = 262,144 rows of a relu1_1 Gram that would leave two
digits. ``set_bf16_numerics`` forbids it, and keeps everything the f32
policy sets: the Grams, the matrix square roots and the f32 cascades of
the same process still run without TF32.
"""

from __future__ import annotations

import subprocess

import torch


def set_fp32_numerics() -> None:
    """Full f32 convs and matmuls (no TF32), deterministic cuDNN."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def set_bf16_numerics() -> None:
    """The f32 policy, plus f32 accumulation in every bf16 matmul."""
    set_fp32_numerics()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def set_numerics(dtype: torch.dtype) -> None:
    """The policy for a cascade whose activations are ``dtype``."""
    if dtype == torch.bfloat16:
        set_bf16_numerics()
    else:
        set_fp32_numerics()


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


def scalar_on(value, device: torch.device) -> torch.Tensor:
    """``value`` (a number or a tensor) as an f32 tensor on ``device``.

    A number is filled in on the device (``torch.full``): ``as_tensor``
    would copy it from pageable host memory, and that copy waits for
    every kernel already queued on the stream, so a cascade holding one
    could never be enqueued ahead of the card. Same f32 value either way.
    """
    if torch.is_tensor(value):
        return value.to(device=device, dtype=torch.float32)
    return torch.full((), float(value), dtype=torch.float32, device=device)


def values_on(values, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``torch.as_tensor(values, device=device).to(dtype)``, the same
    values, without the wait: a tensor passed in goes as it is; numbers
    (a list, a numpy array) are converted to ``dtype`` on the host and
    filled in on the device one ``torch.full`` each, as ``scalar_on``
    fills α, so no copy from pageable host memory waits for the queue.
    For the few interpolation weights of a style blend."""
    if torch.is_tensor(values):
        return values.to(device=device).to(dtype)
    host = torch.as_tensor(values).to(dtype)
    return torch.stack([torch.full((), v, dtype=dtype, device=device)
                        for v in host.flatten().tolist()]).reshape(host.shape)


def card_name() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them: the
    line every timing of the port is written beside."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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
