"""The system under test: every call the benchmark makes into
``wct_tpu_torch``, the PyTorch and CUDA program, in one place.

The benchmark takes from the program only its entry points, its launch
counters and its conv-choice file. Nothing here imports the JAX
package.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from collections.abc import Mapping

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
    """Per level every tensor the style cache holds, as float64 on the
    host, by its path in the level's entry: ``stats.kernel`` and
    ``stats.mean`` (the colouring, at the levels that have one),
    ``adain.mean`` and ``adain.std``, ``fs_white``."""
    def tensors(obj, prefix=""):
        out = {}
        for field in dataclasses.fields(obj):
            value = getattr(obj, field.name)
            if isinstance(value, torch.Tensor):
                out[prefix + field.name] = value.double().cpu()
            elif dataclasses.is_dataclass(value):
                out.update(tensors(value, f"{prefix}{field.name}."))
        return out

    return {level: tensors(s) for level, s in cache.items()}


def stylize_job(params: dict, images_f32: torch.Tensor, cache: dict, alpha: float, cfg,
                microbatch: int) -> torch.Tensor:
    """``stylize_microbatched`` on ``[B, H, W, 3]`` f32 images on the card."""
    return cascade.stylize_microbatched(params, images_f32, cache, alpha, cfg, microbatch)


def counters(declared: dict | None = None) -> dict:
    """The program's launch counters of the kernels whose rooflines the
    benchmark reads, and each counter of ``declared`` (``{key: path}``,
    the metrics' ``COUNTERS``) by ``counter``."""
    out = {
        "junction_f32": junction.junction_cuda.launches_by_dtype["f32"],
        "junction_bf16": junction.junction_cuda.launches_by_dtype["bf16"],
        "centered_gram": gram.centered_gram_cuda.launches,
    }
    out.update({key: counter(path) for key, path in (declared or {}).items()})
    return out


def counter(path: str):
    """The number at ``path`` under ``wct_tpu_torch``: the longest prefix
    that is a module, then attributes or mapping keys
    (``ops.eigh.eigh_cuda.launches``); None where the path does not
    resolve to a number."""
    parts = path.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module("wct_tpu_torch." + ".".join(parts[:i]))
        except ModuleNotFoundError:
            continue
        break
    else:
        return None
    for part in parts[i:]:
        obj = obj.get(part) if isinstance(obj, Mapping) else getattr(obj, part, None)
        if obj is None:
            return None
    return obj if isinstance(obj, (int, float)) and not isinstance(obj, bool) else None


def conv_choices(device_index: int = 0) -> dict:
    """What the program's conv-choice file holds for this card, torch and
    cuDNN: ``{shape: True (cuDNN) | False (PyTorch's own conv)}``."""
    path = convs.CHOICES_PATH
    if path is None or not path.exists():
        return {}
    data = json.loads(path.read_text())
    return data.get(convs._card_key(torch.device("cuda", device_index)), {}).get("inference", {})
