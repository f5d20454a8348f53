"""Activation-normalise an encoder: mean post-ReLU activation → 1.

    python -m wct_tpu_torch.tools.normalize_encoder encoder.npz encoder_norm.npz \
        [--images DIR | --synthetic-pool 64] [--size 128] [--seed 0] [--device cpu]

The port of ``wct_tpu/tools/normalize_encoder.py``, on the port's
encoder (its reflect convs and pools, NCHW, on a device). The
reference's ``vgg_normalised.t7`` is the Gatys activation-normalised
VGG-19: each conv's weights are rescaled so that the mean activation of
every output channel over a dataset is exactly 1. A He-random encoder
lacks that property (its conv0 preprocessing emits O(100) values), and
decoder training against it optimises O(1e4) losses.

Procedure (exact, layer by layer in data-flow order): run an image pool
through the already-normalised prefix, compute each output channel's
mean post-ReLU activation, and scale that channel's weights and bias by
its reciprocal. Positive scaling commutes with ReLU, so each rescale is
a per-channel diagonal of its own output, but the diagonals compose
through the next layer, so deep features are a different function of
the input and decoders must be retrained. ``normalize_bundle_compensated``
keeps the function: it compensates the next conv and the decoders.
``conv0`` (the preprocessing conv) is left untouched.

Parameters are the port's (OIHW tensors, ``{name: {"w", "b"}}``); the
CLI reads and writes the JAX package's HWIO npz files.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from wct_tpu_torch.models import decoder as dec_lib
from wct_tpu_torch.models import vgg
from wct_tpu_torch.ops.convs import conv2d_reflect_nchw, maxpool2_nchw
from wct_tpu_torch.utils.device import set_fp32_numerics


def _chunks(pool: np.ndarray, chunk: int, device: torch.device) -> list[torch.Tensor]:
    """``pool [N, H, W, 3]`` in ``chunk``-image NCHW f32 slices on ``device``."""
    return [torch.as_tensor(pool[i:i + chunk], dtype=torch.float32, device=device)
            .permute(0, 3, 1, 2).contiguous() for i in range(0, len(pool), chunk)]


def _layer(acts: list, kind: str, p: dict) -> list:
    """One encoder conv over every chunk (+ ReLU unless the linear conv0),
    consuming the chunks as it goes, so two layers' activations never
    coexist in full."""
    ys = []
    while acts:
        y = conv2d_reflect_nchw(acts.pop(0), p["w"], p["b"])
        ys.append(y if kind == "conv_pre" else torch.relu(y))
    return ys


def _channel_stat(ys: list, n: int, stat: str = "mean") -> torch.Tensor:
    """Each channel's mean (or root mean square) over every chunk, each
    chunk weighted by its size (the last may be short)."""
    if stat == "rms":
        return torch.sqrt(sum(y.shape[0] * y.square().mean(dim=(0, 2, 3)) for y in ys) / n)
    if stat == "mean":
        return sum(y.shape[0] * y.mean(dim=(0, 2, 3)) for y in ys) / n
    raise ValueError(f"stat must be 'mean' or 'rms', got {stat!r}")


def _device(params: dict) -> torch.device:
    return params["conv1_1"]["w"].device


@torch.no_grad()
def channel_means(params: dict, pool: np.ndarray, chunk: int = 8) -> dict:
    """Mean post-ReLU activation per channel of every conv over ``pool
    [N, H, W, 3]``, as numpy ``{name: [C]}``, on ``params``' device.

    The pool runs in ``chunk``-image slices, but one layer's activations
    for the whole pool are held at once: peak memory is about the widest
    tier's activations for the pool.
    """
    set_fp32_numerics()
    means: dict[str, np.ndarray] = {}
    acts = _chunks(pool, chunk, _device(params))
    for spec in vgg.ENCODER_LAYERS:
        if spec[0] == "pool":
            acts = [maxpool2_nchw(a) for a in acts]
            continue
        acts = _layer(acts, spec[0], params[spec[1]])
        means[spec[1]] = _channel_stat(acts, len(pool)).cpu().numpy()
    return means


def _scale(stat: torch.Tensor, floor: float) -> torch.Tensor:
    """1 / stat per channel; dead channels (stat ≤ floor: ReLU never fires
    on the pool) keep scale 1, since 1/0 would amplify noise."""
    return torch.where(stat > floor, 1.0 / stat.clamp_min(floor), torch.ones_like(stat))


@torch.no_grad()
def normalize_encoder(
    params: dict, pool: np.ndarray, chunk: int = 8, floor: float = 1e-4
) -> tuple[dict, dict]:
    """Return (normalised params, report). Layer-sequential and exact:
    each layer's scale comes from activations of the already-normalised
    prefix, so afterwards every conv's channels have mean activation 1
    over the pool (up to rounding)."""
    set_fp32_numerics()
    out = {k: dict(v) for k, v in params.items()}
    report: dict[str, dict] = {}
    acts = _chunks(pool, chunk, _device(params))
    for spec in vgg.ENCODER_LAYERS:
        if spec[0] == "pool":
            acts = [maxpool2_nchw(a) for a in acts]
            continue
        kind, name = spec[0], spec[1]
        p = out[name]
        ys = _layer(acts, kind, p)
        if kind == "conv_pre":  # leave the preprocessing conv alone
            acts = ys
            continue
        mean = _channel_stat(ys, len(pool))
        s = _scale(mean, floor)
        out[name] = {"w": p["w"].float() * s[:, None, None, None], "b": p["b"].float() * s}
        acts = [y * s[None, :, None, None] for y in ys]  # relu(s·x) = s·relu(x), s > 0
        report[name] = {"mean_before": float(mean.mean()),
                        "dead_channels": int((mean <= floor).sum())}
    return out, report


@torch.no_grad()
def normalize_bundle_compensated(
    bundle: dict, pool: np.ndarray, chunk: int = 8, floor: float = 1e-4, stat: str = "mean",
) -> tuple[dict, dict]:
    """Function-preserving activation normalisation of a trained bundle
    ``{"encoder": ..., "decoders": {target: ...}}``.

    - conv ℓ's weights and bias are scaled per output channel by
      ``s_ℓ = 1/stat`` (positive scales commute with ReLU and max-pool);
    - the next conv's input channels are multiplied by ``1/s_ℓ``, so the
      trunk as a function is unchanged except that layer ℓ's features are
      rescaled by ``s_ℓ``;
    - each decoder's first conv absorbs its level's ``1/s`` the same way,
      so ``decode(encode(x))`` is preserved to rounding.

    ``stat`` is the per-channel statistic driven to 1: ``"mean"`` (the
    Gatys procedure) or ``"rms"`` (unit second moment, which bounds every
    channel's variance). Returns ``({'encoder':..., 'decoders':...},
    report)``.
    """
    set_fp32_numerics()
    enc = {k: dict(v) for k, v in bundle["encoder"].items()}
    decs = {t: {n: dict(c) for n, c in d.items()} for t, d in bundle["decoders"].items()}
    conv_names = [s[1] for s in vgg.ENCODER_LAYERS if s[0] == "conv"]
    next_conv = dict(zip(conv_names, conv_names[1:]))
    report: dict[str, dict] = {}
    acts = _chunks(pool, chunk, _device(enc))
    for spec in vgg.ENCODER_LAYERS:
        if spec[0] == "pool":
            acts = [maxpool2_nchw(a) for a in acts]
            continue
        kind, name = spec[0], spec[1]
        p = enc[name]
        ys = _layer(acts, kind, p)
        if kind == "conv_pre":  # the preprocessing conv stays as it is
            acts = ys
            continue
        value = _channel_stat(ys, len(pool), stat)
        s = _scale(value, floor)
        inv = 1.0 / s
        enc[name] = {"w": p["w"].float() * s[:, None, None, None], "b": p["b"].float() * s}
        nxt = next_conv.get(name)
        if nxt is not None:  # compensate the next conv's input channels
            q = enc[nxt]
            enc[nxt] = {"w": q["w"].float() * inv[None, :, None, None], "b": q["b"]}
        level = f"relu{name[4]}_1" if name.endswith("_1") else None
        if level in decs:  # and the first conv of the decoder it feeds
            first = dec_lib.decoder_layers(level)[0][1]
            d = decs[level][first]
            decs[level][first] = {"w": d["w"].float() * inv[None, :, None, None], "b": d["b"]}
        acts = [y * s[None, :, None, None] for y in ys]
        report[name] = {"mean_before": float(value.mean()),
                        "dead_channels": int((value <= floor).sum())}
    return {"encoder": enc, "decoders": decs}, report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("encoder", help="input encoder npz (flat or {'encoder': ...})")
    p.add_argument("out", help="output npz ({'encoder': ...})")
    p.add_argument("--images", default=None, help="reference image dir")
    p.add_argument("--synthetic-pool", type=int, default=64,
                   help="procedural pool size when no --images")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk", type=int, default=8)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    from wct_tpu_torch.train import checkpoint

    tree = checkpoint.load_pytree(args.encoder)
    raw = tree["encoder"] if "encoder" in tree else tree
    # Everything else in the input tree (a bundle's decoders) passes
    # through; decoders trained against the unnormalised encoder must be
    # retrained (module docstring).
    extras = {k: v for k, v in tree.items() if k != "encoder"} if "encoder" in tree else {}
    if extras:
        print(f"note: passing through non-encoder keys {sorted(extras)}; "
              "decoders trained against the unnormalised encoder must be "
              "retrained", file=sys.stderr)
    params = checkpoint.params_from_numpy(raw, args.device)

    if args.images:
        from wct_tpu_torch.utils import images as img_utils

        paths = img_utils.list_images(args.images)
        if not paths:
            print(f"no images under {args.images}", file=sys.stderr)
            return 1
        pool = np.stack([
            img_utils.center_crop(img_utils.resize_to(img_utils.get_img(f), args.size), args.size)
            for f in paths[: args.synthetic_pool]
        ])
    else:
        from wct_tpu_torch.train.data import synthetic_image

        rng = np.random.default_rng(args.seed)
        pool = np.stack([synthetic_image(rng, args.size) for _ in range(args.synthetic_pool)])

    normed, report = normalize_encoder(params, pool, chunk=args.chunk)
    for name, r in report.items():
        print(f"{name:<10} mean activation {r['mean_before']:>10.3f} → 1.0"
              f"  (dead channels: {r['dead_channels']})")

    after = channel_means(normed, pool, chunk=args.chunk)
    worst = max(abs(float(np.mean(m)) - 1.0) for n, m in after.items() if n != "conv0")
    print(f"post-check: worst |mean−1| over conv layers = {worst:.2e}")

    checkpoint.save_pytree(args.out, {"encoder": checkpoint.params_to_numpy(normed), **extras})
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
