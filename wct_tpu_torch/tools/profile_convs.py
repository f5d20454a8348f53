"""Time every conv of the cascade on the card: cuDNN, PyTorch's own, the port's.

    python -m wct_tpu_torch.tools.profile_convs [--size 512] [--batch 4]

Walks the encoder (to relu5_1) and the five decoders at the shapes the
cascade runs them, with the trained bundle, and times each reflect conv
with CUDA events under the port's numerics (NCHW, no TF32,
deterministic cuDNN, no autotuning):

- ``cudnn_ms``: cuDNN forced on;
- ``cudnn_benchmark_ms``, ``cudnn_nondeterministic_ms``,
  ``cudnn_channels_last_ms``: cuDNN with its autotuner on, with
  ``deterministic=False``, or with NHWC memory order;
- ``native_ms``: cuDNN off, PyTorch's own conv (im2col + GEMM);
- ``port_ms``: ``conv2d_reflect_nchw`` as the cascade runs it, which
  keeps cuDNN for a shape unless it measured more than 2× slower than
  the native conv (``ops/convs.py``); ``cudnn`` says which it kept.

Prints one JSON line per conv, the top device kernels of the slowest
cuDNN conv from ``torch.profiler``, and the totals.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from wct_tpu_torch.models import decoder, vgg
from wct_tpu_torch.ops import convs
from wct_tpu_torch.ops.convs import conv2d_reflect_nchw, pad_reflect_nchw, upsample_nearest2_nchw
from wct_tpu_torch.train import checkpoint
from wct_tpu_torch.utils.device import cuda_ms, resolve_device, set_fp32_numerics

ROOT = Path(__file__).resolve().parents[2]


def _convs(params, x):
    """(where, name, input, weight, bias) for every conv the cascade runs."""
    out = []
    h = x
    for spec in vgg.ENCODER_LAYERS:
        if spec[0] == "pool":
            h = torch.nn.functional.max_pool2d(h, 2, 2)
            continue
        p = params["encoder"][spec[1]]
        out.append(("encoder", spec[1], h, p["w"], p["b"]))
        h = conv2d_reflect_nchw(h, p["w"], p["b"])
        if spec[0] == "conv":
            h = torch.relu(h)
    for target in vgg.RELU_TARGETS:
        scale = vgg.TARGET_SCALE[target]
        c = vgg.TARGET_CHANNELS[target]
        f = torch.rand(x.shape[0], c, x.shape[2] // scale, x.shape[3] // scale,
                       device=x.device)
        for spec in decoder.decoder_layers(target):
            if spec[0] == "upsample":
                f = upsample_nearest2_nchw(f)
                continue
            p = params["decoders"][target][spec[1]]
            out.append((f"decoder_{target}", spec[1], f, p["w"], p["b"]))
            f = torch.relu(conv2d_reflect_nchw(f, p["w"], p["b"]))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    params = checkpoint.params_from_numpy(
        checkpoint.load_pytree(ROOT / "weights" / "bundle.npz"), dev
    )
    x = torch.as_tensor(
        np.random.default_rng(0).random((args.batch, 3, args.size, args.size), np.float32),
        device=dev,
    )
    rows = []
    with torch.no_grad():
        for where, name, inp, w, b in _convs(params, x):
            row = {"where": where, "conv": name, "input": list(inp.shape),
                   "out_c": w.shape[0], "k": w.shape[2]}
            padded = pad_reflect_nchw(inp, (w.shape[2] - 1) // 2)
            conv = torch.nn.functional.conv2d
            for key, enabled in (("cudnn_ms", True), ("native_ms", False)):
                with convs._cudnn(enabled):
                    row[key] = cuda_ms(lambda: conv(padded, w, b))
            padded_cl = padded.contiguous(memory_format=torch.channels_last)
            w_cl = w.contiguous(memory_format=torch.channels_last)
            with convs._cudnn(True):
                row["cudnn_channels_last_ms"] = cuda_ms(lambda: conv(padded_cl, w_cl, b))
                torch.backends.cudnn.benchmark = True
                row["cudnn_benchmark_ms"] = cuda_ms(lambda: conv(padded, w, b))
                set_fp32_numerics()
                torch.backends.cudnn.deterministic = False
                row["cudnn_nondeterministic_ms"] = cuda_ms(lambda: conv(padded, w, b))
                set_fp32_numerics()
            row["port_ms"] = cuda_ms(lambda: conv2d_reflect_nchw(inp, w, b))
            row["cudnn"] = convs._CUDNN_OK[(tuple(padded.shape), tuple(w.shape), padded.dtype,
                                            padded.device)]
            print(json.dumps(row), flush=True)
            rows.append((row, padded, w, b))
        slow, padded, w, b = max(rows, key=lambda r: r[0]["cudnn_ms"])
        from torch.profiler import ProfilerActivity, profile

        with convs._cudnn(True), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
        ) as prof:
            torch.nn.functional.conv2d(padded, w, b)
            torch.cuda.synchronize()
        top = [
            {"kernel": e.key[:120], "device_ms": e.device_time_total / 1e3, "count": e.count}
            for e in sorted(prof.key_averages(), key=lambda e: -e.device_time_total)[:8]
        ]
        print(json.dumps({"slowest": slow, "profile": top}), flush=True)
    print(json.dumps({f"{k}_total": sum(r[0][k] for r in rows)
                      for k in ("cudnn_ms", "cudnn_benchmark_ms", "cudnn_nondeterministic_ms",
                                "cudnn_channels_last_ms", "native_ms", "port_ms")}))


if __name__ == "__main__":
    main()
