"""The system under test: every call the benchmark makes into
``wct_tpu_torch``, the PyTorch and CUDA program, in one place.

The benchmark takes from the program only its entry points, its launch
counters and its conv-choice file. Nothing here imports the JAX
package.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from wct_tpu_torch.models import cascade
from wct_tpu_torch.ops import convs, gram, junction
from wct_tpu_torch.train import checkpoint

from harness.spec import ROOT


def cascade_config(config: dict) -> cascade.CascadeConfig:
    return cascade.CascadeConfig(relu_targets=tuple(config["relu_targets"]), **config["cascade"])


def load_params(config: dict, device) -> dict:
    """The trained bundle the configuration names, on ``device``, for its
    relu targets."""
    tree = checkpoint.load_pytree(ROOT / config["weights"])
    tree["decoders"] = {t: tree["decoders"][t] for t in config["relu_targets"]}
    return checkpoint.params_from_numpy(tree, device)


def precompute_style(params: dict, style_u8: np.ndarray, cfg) -> dict:
    return cascade.precompute_style(params["encoder"], style_u8.astype(np.float32) / 255.0, cfg)


def style_statistics(cache: dict) -> dict:
    """The cached colouring matrix and mean of every level, as float64 on the host."""
    return {level: (s.stats.kernel.double().cpu(), s.stats.mean.double().cpu())
            for level, s in cache.items()}


def stylize_job(params: dict, images_f32: torch.Tensor, cache: dict, alpha: float, cfg,
                microbatch: int) -> torch.Tensor:
    """``stylize_microbatched`` on ``[B, H, W, 3]`` f32 images on the card."""
    return cascade.stylize_microbatched(params, images_f32, cache, alpha, cfg, microbatch)


def counters() -> dict:
    """The program's launch counters of the kernels whose rooflines the
    benchmark reads."""
    return {
        "junction_f32": junction.junction_cuda.launches_by_dtype["f32"],
        "junction_bf16": junction.junction_cuda.launches_by_dtype["bf16"],
        "centered_gram": gram.centered_gram_cuda.launches,
    }


def conv_choices(device_index: int = 0) -> dict:
    """What the program's conv-choice file holds for this card, torch and
    cuDNN: ``{shape: True (cuDNN) | False (PyTorch's own conv)}``."""
    path = convs.CHOICES_PATH
    if path is None or not path.exists():
        return {}
    data = json.loads(path.read_text())
    return data.get(convs._card_key(torch.device("cuda", device_index)), {}).get("inference", {})
