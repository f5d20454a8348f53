"""Converter: TF-1 decoder checkpoints → decoder npz trees.

    python -m wct_tpu_torch.tools.convert_tf_ckpt --relu-target relu5_1 \
        /path/to/ckpt_dir decoder_relu5_1.npz

The port of ``wct_tpu/tools/convert_tf_ckpt.py``. It reads any TF
checkpoint (TensorFlow is imported inside ``load_tf_checkpoint``, so
the module imports without it), picks conv kernel/bias pairs, orders
them by the checkpoint's sorted variable names, and maps them by
position onto ``decoder_layers(target)`` with shape validation, so it
fails loudly on anything that does not mirror the decoder. Keras HWIO
kernels are assumed (the TF-1 Keras Conv2D default) and written as they
are, the JAX package's file layout, which loads in either package. No
device is involved.
"""

from __future__ import annotations

import argparse
import re

import numpy as np

from wct_tpu_torch.models import decoder as dec_lib
from wct_tpu_torch.train import checkpoint


def _natural_key(name: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]


def tf_vars_to_decoder_params(
    variables: dict[str, np.ndarray], target: str
) -> dict:
    """Map {tf_var_name: array} onto the ``target`` decoder pytree."""
    conv_specs = [s for s in dec_lib.decoder_layers(target) if s[0] == "conv"]

    kernels = sorted(
        (n for n, v in variables.items() if np.ndim(v) == 4),
        key=_natural_key,
    )
    biases = sorted(
        (n for n, v in variables.items() if np.ndim(v) == 1),
        key=_natural_key,
    )
    if len(kernels) != len(conv_specs) or len(biases) != len(conv_specs):
        raise ValueError(
            f"checkpoint has {len(kernels)} kernels / {len(biases)} biases; "
            f"decoder {target} needs {len(conv_specs)} conv layers"
        )

    params: dict = {}
    for spec, k_name, b_name in zip(conv_specs, kernels, biases):
        _, name, in_c, out_c, k = spec
        w = np.asarray(variables[k_name], dtype=np.float32)
        b = np.asarray(variables[b_name], dtype=np.float32)
        if w.shape != (k, k, in_c, out_c):
            raise ValueError(
                f"{name}: kernel {k_name} shape {w.shape} != expected "
                f"{(k, k, in_c, out_c)} (HWIO)"
            )
        if b.shape != (out_c,):
            raise ValueError(f"{name}: bias {b_name} shape {b.shape}")
        params[name] = {"w": w, "b": b}
    return params


def load_tf_checkpoint(ckpt_dir: str) -> dict[str, np.ndarray]:
    """Read all variables from a TF checkpoint dir or prefix."""
    try:
        import tensorflow as tf  # noqa: PLC0415
    except ImportError as e:  # pragma: no cover
        raise SystemExit("tensorflow is required to read TF checkpoints") from e
    prefix = tf.train.latest_checkpoint(ckpt_dir) or ckpt_dir
    reader = tf.train.load_checkpoint(prefix)
    return {
        name: reader.get_tensor(name)
        for name in reader.get_variable_to_shape_map()
        if "Adam" not in name and "global_step" not in name
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("ckpt_dir", help="TF checkpoint dir or prefix")
    p.add_argument("out_npz")
    p.add_argument("--relu-target", required=True)
    args = p.parse_args(argv)
    variables = load_tf_checkpoint(args.ckpt_dir)
    params = tf_vars_to_decoder_params(variables, args.relu_target)
    checkpoint.save_pytree(args.out_npz, params)
    print(f"wrote {args.out_npz}: {len(params)} convs for {args.relu_target}")


if __name__ == "__main__":
    main()
