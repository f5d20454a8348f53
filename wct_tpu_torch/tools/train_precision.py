"""How far the training route's gradients lie from float64, and where.

    python -m wct_tpu_torch.tools.train_precision [--target relu5_1] [--crop 256] [--batch 8]

On the card, with the trained bundle: one batch from the seeded synthetic
pool, the first step's gradients of the trained decoder in float64, then
in f32 three ways (the per-shape choice of ``ops/convs.py``, every conv
on cuDNN, every conv on PyTorch's own conv), each leaf's relative
Frobenius error against float64. Then, for the per-shape choice, the
relative error of the gradient entering each conv's backward, in the
order the backward meets them: where it jumps is where a ReLU or a max
pool decided otherwise in f32 than in float64. Prints JSON lines.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from wct_tpu_torch.models import decoder, vgg
from wct_tpu_torch.ops import convs
from wct_tpu_torch.ops.convs import to_nchw
from wct_tpu_torch.train import checkpoint, trainer
from wct_tpu_torch.train.data import device_pool_batches, synthetic_pool
from wct_tpu_torch.utils.device import card_name, resolve_device

ROOT = Path(__file__).resolve().parents[2]


def _grads(dec, enc, batch, target, dtype):
    """Loss and gradients of pixel + feature L2 (weights 1) in ``dtype``."""
    params = {n: {k: v.detach().to(dtype).clone().requires_grad_(True) for k, v in leaf.items()}
              for n, leaf in dec.items()}
    enc = {n: {k: v.to(dtype) for k, v in leaf.items()} for n, leaf in enc.items()}
    x = to_nchw(batch.to(dtype) / 255.0)
    code = vgg.encode_multi_nchw(enc, x, (target,))[target]
    decoded = decoder.decode_nchw(params, code, target)
    recode = vgg.encode_multi_nchw(enc, decoded, (target,))[target]
    loss = (decoded - x).pow(2).mean() + (recode - code).pow(2).mean()
    loss.backward()
    return float(loss.detach()), {f"{n}/{k}": v.grad for n, leaf in params.items()
                                  for k, v in leaf.items()}


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--target", default="relu5_1")
    ap.add_argument("--crop", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(card_name(), flush=True)
    params = checkpoint.params_from_numpy(
        checkpoint.load_pytree(ROOT / "weights" / "bundle.npz"), dev)
    enc, dec = params["encoder"], params["decoders"][args.target]
    pool = synthetic_pool(np.random.default_rng(20), 64, args.crop)
    batch = next(device_pool_batches(pool, args.batch, seed=0, device=dev))

    entering = []  # (input shape, weight shape, cuDNN?, gradient entering the backward)
    backward = convs._ConvByShape.backward

    def recording(ctx, gy):
        x, w = ctx.saved_tensors
        entering.append((list(x.shape), list(w.shape), ctx.use_cudnn, gy.detach().clone()))
        return backward(ctx, gy)

    convs._ConvByShape.backward = staticmethod(recording)
    choose = convs._cudnn_ok_train
    try:
        loss64, g64 = _grads(dec, enc, batch, args.target, torch.float64)
        trail64 = list(entering)
        for route in ("per_shape", "cudnn", "native"):
            entering.clear()
            convs.CONV_TIMES.clear()

            def forced(x, w, b, route=route):
                row = choose(x, w, b)
                if route != "per_shape":
                    row["cudnn_fwd"] = row["cudnn_bwd"] = route == "cudnn"
                return row

            convs._cudnn_ok_train = forced
            loss32, g32 = _grads(dec, enc, batch, args.target, torch.float32)
            errs = {k: _rel(g32[k], g64[k]) for k in g64}
            print(json.dumps({
                "route": route, "target": args.target, "crop": args.crop, "batch": args.batch,
                **{f"native_{d}_shapes": sum(not t[f"cudnn_{d}"] for t in convs.CONV_TIMES.values())
                   for d in ("fwd", "bwd")},
                "shapes": len(convs.CONV_TIMES), "loss_rel": abs(loss32 - loss64) / loss64,
                "max_leaf": max(errs.values()), "max_leaf_name": max(errs, key=errs.get),
                "all_leaves": _rel(torch.cat([g32[k].ravel() for k in g64]),
                                   torch.cat([g64[k].ravel() for k in g64])),
            }), flush=True)
            if route == "per_shape":
                for i, ((xs, ws, on_cudnn, gy), (_, _, _, gy64)) in enumerate(
                        zip(entering, trail64)):
                    print(json.dumps({"backward_call": i, "input": xs, "weight": ws,
                                      "cudnn": on_cudnn, "grad_in_rel": _rel(gy, gy64)}),
                          flush=True)
    finally:
        convs._ConvByShape.backward = backward
        convs._cudnn_ok_train = choose


if __name__ == "__main__":
    main()
