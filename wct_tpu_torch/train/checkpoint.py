"""Flat-npz pytree I/O and the weight bridge to the port's layout.

The file format is the JAX package's (``wct_tpu/train/checkpoint.py``):
one ``.npz`` whose keys are flat ``a/b/c`` paths, float16 leaves
upcast to float32 on load. So ``weights/bundle.npz`` is read as it is,
and a tree written here loads in either package.

The trees stay numpy on disk and in ``load_pytree``'s result, with the
JAX package's HWIO conv weights. ``params_from_numpy`` turns such a
tree into the port's parameters: OIHW tensors on a device.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from wct_tpu_torch.utils.device import resolve_device

_SEP = "/"


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(_flatten(v, f"{prefix}{i}{_SEP}"))
    elif isinstance(tree, torch.Tensor):
        flat[prefix.rstrip(_SEP)] = tree.detach().cpu().numpy()
    else:
        flat[prefix.rstrip(_SEP)] = np.asarray(tree)
    return flat


def _unflatten(flat: dict[str, np.ndarray]) -> Any:
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return _maybe_listify(tree)


def _maybe_listify(node: Any) -> Any:
    """Turn {'0': ..., '1': ...} dicts (from saved lists) back into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _maybe_listify(v) for k, v in node.items()}
    keys = list(node.keys())
    if keys and all(k.isdigit() for k in keys):
        return [node[str(i)] for i in range(len(keys))]
    return node


def save_pytree(path: str | os.PathLike, tree: Any) -> None:
    """Save a tree of arrays or tensors as one ``.npz`` (atomic rename).

    Tensors are written as they are; to write port parameters in the
    JAX package's layout, pass ``params_to_numpy(params)``.
    """
    path = str(path)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **_flatten(tree))
    os.replace(tmp, path)


def load_pytree(path: str | os.PathLike, upcast_f16: bool = True) -> Any:
    """Load an ``.npz`` checkpoint into a nested dict/list of numpy arrays.

    float16 is a storage format only, so by default it comes back as
    float32 (``wct_tpu/train/checkpoint.py:81-98``).
    """
    with np.load(str(path)) as data:
        return _unflatten({
            k: (data[k].astype(np.float32)
                if upcast_f16 and data[k].dtype == np.float16 else data[k])
            for k in data.files
        })


def _map_tree(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def params_from_numpy(tree: Any, device: str | torch.device = "cuda") -> Any:
    """JAX-layout numpy parameters → the port's tensors on ``device``.

    Every 4-D leaf is a conv weight and goes HWIO → OIHW; every other
    leaf keeps its shape. Values and dtypes are unchanged.
    """
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        return torch.tensor(np.ascontiguousarray(a), device=dev)  # a copy

    return _map_tree(leaf, tree)


def params_to_numpy(tree: Any) -> Any:
    """Inverse of ``params_from_numpy``: OIHW tensors → HWIO numpy."""

    def leaf(t):
        a = t.detach().cpu().numpy()
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if a.ndim == 4 else a

    return _map_tree(leaf, tree)
