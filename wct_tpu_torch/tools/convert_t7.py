"""Offline converter: vgg_normalised.t7 → encoder npz tree.

    python -m wct_tpu_torch.tools.convert_t7 vgg_normalised.t7 encoder.npz

The port of ``wct_tpu/tools/convert_t7.py``: walk the ``nn.Sequential``
module list, take every ``SpatialConvolution``'s weights, and key them
against ``vgg.ENCODER_LAYERS`` by position (conv0 = the 1×1
preprocessing conv whose weights bake in RGB→scaled-BGR-minus-means;
padding/ReLU/pool modules carry no weights). The file is written in the
JAX package's HWIO layout (OIHW → HWIO), so it loads in either package;
``train.checkpoint.params_from_numpy`` turns it into the port's tensors.
No device is involved.

The channel shapes of every conv are validated against the encoder
spec, so a mismatched or truncated t7 fails loudly instead of
producing a silently-wrong encoder.
"""

from __future__ import annotations

import argparse
from typing import Any

import numpy as np

from wct_tpu_torch.models import vgg
from wct_tpu_torch.tools import t7_reader
from wct_tpu_torch.train import checkpoint


def _iter_modules(obj: Any):
    """Depth-first walk of nn containers, yielding leaf modules."""
    if isinstance(obj, t7_reader.TorchObject):
        modules = obj.get("modules")
        if modules is not None:
            for m in modules:
                yield from _iter_modules(m)
        else:
            yield obj
    elif isinstance(obj, list):
        for m in obj:
            yield from _iter_modules(m)


def t7_to_encoder_params(t7_obj: Any) -> dict:
    """Map the t7 module list onto the encoder tree (numpy, HWIO)."""
    conv_specs = [s for s in vgg.ENCODER_LAYERS if s[0] != "pool"]
    convs = [
        m
        for m in _iter_modules(t7_obj)
        if m.torch_typename.endswith("SpatialConvolution")
    ]
    if len(convs) < len(conv_specs):
        raise ValueError(
            f"t7 has {len(convs)} convolutions; encoder needs "
            f"{len(conv_specs)} (through relu5_1)"
        )

    params: dict = {}
    for spec, mod in zip(conv_specs, convs):
        _, name, in_c, out_c, k = spec
        w = np.asarray(mod["weight"], dtype=np.float32)
        b = np.asarray(mod["bias"], dtype=np.float32)
        if w.ndim == 2:  # some exports flatten 1×1 convs
            w = w.reshape(out_c, in_c, 1, 1)
        if w.shape != (out_c, in_c, k, k):
            raise ValueError(
                f"{name}: t7 weight shape {w.shape} != expected "
                f"{(out_c, in_c, k, k)} (OIHW)"
            )
        params[name] = {
            "w": w.transpose(2, 3, 1, 0),  # OIHW → HWIO, the file layout
            "b": b,
        }
    return params


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("t7_path")
    p.add_argument("out_npz")
    args = p.parse_args(argv)
    t7 = t7_reader.load_t7(args.t7_path)
    params = t7_to_encoder_params(t7)
    checkpoint.save_pytree(args.out_npz, {"encoder": params})
    total = sum(np.asarray(v["w"]).size for v in params.values())
    print(f"wrote {args.out_npz}: {len(params)} convs, {total:,} weights")


if __name__ == "__main__":
    main()
