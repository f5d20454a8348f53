"""Assemble encoder + per-level decoder npz files into one weight bundle.

    python -m wct_tpu_torch.tools.make_bundle --encoder encoder.npz \
        --decoder relu5_1=ckpt/relu5_1/decoder_relu5_1.npz \
        --decoder relu4_1=ckpt/relu4_1/decoder_relu4_1.npz \
        ... bundle.npz

The port of ``wct_tpu/tools/make_bundle.py``. The bundle
(``{"encoder": ..., "decoders": {target: ...}}``) is what the inference
CLIs take as ``--weights``; a decoder file may be a raw decoder tree or a
training state's ``{"params": ...}``. Every decoder is shape-checked
against its level's architecture before writing, in the files' own HWIO
layout, so the file is the JAX package's and loads in either package.
No device is involved: the trees stay numpy.
"""

from __future__ import annotations

import argparse

import numpy as np

from wct_tpu_torch.models import decoder as dec_lib
from wct_tpu_torch.train import checkpoint


def validate_decoder(params: dict, target: str) -> None:
    """Raise ``ValueError`` unless ``params`` (a numpy tree, HWIO weights)
    holds every conv of the ``target`` decoder at its shape."""
    specs = [s for s in dec_lib.decoder_layers(target) if s[0] == "conv"]
    for _, name, in_c, out_c, k in specs:
        if name not in params:
            raise ValueError(f"decoder {target}: missing conv {name!r}")
        w = np.asarray(params[name]["w"])
        if w.shape != (k, k, in_c, out_c):
            raise ValueError(
                f"decoder {target} {name}: weight {w.shape} != "
                f"{(k, k, in_c, out_c)}"
            )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--encoder", required=True, help="encoder npz "
                   "(from tools/convert_t7 or a bundle with 'encoder')")
    p.add_argument("--decoder", action="append", required=True,
                   metavar="TARGET=PATH",
                   help="relu target = decoder npz (repeatable)")
    p.add_argument("--store-dtype", choices=("float32", "float16"),
                   default="float32",
                   help="on-disk dtype for float weights; float16 halves "
                   "the artifact (~1e-3 relative rounding, upcast to f32 "
                   "on load by checkpoint.load_pytree)")
    p.add_argument("out_npz")
    args = p.parse_args(argv)

    enc = checkpoint.load_pytree(args.encoder)
    enc = enc["encoder"] if "encoder" in enc else enc

    decoders: dict = {}
    for spec in args.decoder:
        target, _, path = spec.partition("=")
        if not path:
            raise SystemExit(f"--decoder needs TARGET=PATH, got {spec!r}")
        tree = checkpoint.load_pytree(path)
        # accept a raw decoder tree or a train-state {'params': ...}
        params = tree.get("params", tree) if isinstance(tree, dict) else tree
        validate_decoder(params, target)
        decoders[target] = params

    bundle = {"encoder": enc, "decoders": decoders}
    if args.store_dtype == "float16":
        bundle = checkpoint._map_tree(
            lambda a: np.asarray(a).astype(np.float16)
            if np.issubdtype(np.asarray(a).dtype, np.floating) else a,
            bundle,
        )
    checkpoint.save_pytree(args.out_npz, bundle)
    print(f"wrote {args.out_npz}: encoder + decoders {sorted(decoders)}"
          + (f" (stored {args.store_dtype})"
             if args.store_dtype != "float32" else ""))


if __name__ == "__main__":
    main()
