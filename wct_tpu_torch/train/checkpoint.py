"""Flat-npz pytree I/O and the weight bridge to the port's layout.

The file format is the JAX package's (``wct_tpu/train/checkpoint.py``):
one ``.npz`` whose keys are flat ``a/b/c`` paths, float16 leaves
upcast to float32 on load. So ``weights/bundle.npz`` is read as it is,
and a tree written here loads in either package.

The trees stay numpy on disk and in ``load_pytree``'s result, with the
JAX package's HWIO conv weights. ``params_from_numpy`` turns such a
tree into the port's parameters: OIHW tensors on a device.

A training state (``TrainCheckpointer``'s ``state_latest.npz``) keeps the
JAX package's keys too: ``params/…``, ``opt_state/0/0`` (Adam's count),
``opt_state/0/1/…`` (first moments), ``opt_state/0/2/…`` (second
moments), ``opt_state/1/0`` (the schedule's count) and ``step``, as
optax flattens ``(ScaleByAdamState, ScaleByScheduleState)``. Moments are
stored HWIO, as the parameters are. So a run started by either package
resumes in the other; ``train_state_to_numpy`` and ``load_adam_state``
map ``torch.optim.Adam``'s ``step``, ``exp_avg`` and ``exp_avg_sq`` to
and from that layout.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from wct_tpu_torch.ops.wct import ITEM_ORBAX, not_ported
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


def tree_leaves(tree: Any) -> list:
    """The leaves of a nested dict/list, in its iteration order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _paired_leaves(tree: Any, other: Any) -> list[tuple]:
    """(leaf of ``tree``, leaf of ``other`` at the same key path), over
    ``tree``'s paths: dict orders may differ between the two."""
    if isinstance(tree, dict):
        return [pair for k, v in tree.items() for pair in _paired_leaves(v, other[k])]
    return [(tree, other)]


def train_state_to_numpy(params: dict, optimizer: torch.optim.Adam, step: int) -> dict:
    """Parameters, Adam state and step as the JAX package saves them.

    A parameter Adam has not stepped yet has zero moments, as optax's
    ``init`` gives them.
    """
    counts = {int(s["step"]) for s in optimizer.state.values()} or {0}
    if len(counts) != 1:
        raise ValueError(f"Adam's parameters have different step counts: {sorted(counts)}")
    count = np.int32(counts.pop())

    def moment(name):
        return params_to_numpy(_map_tree(
            lambda p: optimizer.state[p][name] if p in optimizer.state else torch.zeros_like(p),
            params,
        ))

    return {
        "params": params_to_numpy(params),
        "opt_state": [[count, moment("exp_avg"), moment("exp_avg_sq")], [count]],
        "step": np.int32(step),
    }


def load_adam_state(optimizer: torch.optim.Adam, params: dict, opt_state: Any) -> None:
    """Set ``optimizer``'s state over ``params`` from a saved ``opt_state``
    (``[[count, mu, nu], [count]]``, HWIO moments, as ``load_pytree`` gives
    it)."""
    (count, mu, nu), _ = opt_state
    dev = tree_leaves(params)[0].device
    mu_t, nu_t = params_from_numpy(mu, dev), params_from_numpy(nu, dev)
    for (p, m), (_, v) in zip(_paired_leaves(params, mu_t), _paired_leaves(params, nu_t)):
        if m.shape != p.shape or v.shape != p.shape:
            raise ValueError(f"saved moment shape {tuple(m.shape)} for a {tuple(p.shape)} parameter")
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": m.to(p.dtype),
            "exp_avg_sq": v.to(p.dtype),
        }


def canonicalize(tree: Any) -> Any:
    """A tree (tensors, arrays, tuples included) as the nested dicts/lists
    of numpy arrays that ``load_pytree`` gives for the same tree."""
    return _unflatten(_flatten(tree))


class TrainCheckpointer:
    """Periodic training-state checkpoints: one ``<dir>/state_latest.npz``,
    overwritten atomically. ``save`` is synchronous, so a save on a signal
    is on disk before the process exits.

    The JAX package's second backend, orbax, is a JAX library; asking for
    it raises, naming its ROADMAP item. ``keep`` (orbax's retention) is
    taken for the same signature and has nothing to retain here.
    """

    def __init__(self, ckpt_dir: str | os.PathLike, fmt: str = "npz", keep: int = 3):
        if fmt not in ("npz", "orbax"):
            raise ValueError(f"unknown checkpoint format: {fmt!r}")
        if fmt == "orbax":
            raise not_ported("the orbax checkpoint backend", ITEM_ORBAX)
        self.dir = os.path.abspath(str(ckpt_dir))
        os.makedirs(self.dir, exist_ok=True)

    @property
    def _npz_path(self) -> str:
        return os.path.join(self.dir, "state_latest.npz")

    def save(self, step: int, tree: Any) -> None:
        save_pytree(self._npz_path, tree)

    def restore_latest(self) -> Any | None:
        """The latest saved training state (canonical tree) or None."""
        if not os.path.exists(self._npz_path):
            return None
        return load_pytree(self._npz_path)

    def close(self) -> None:
        pass
