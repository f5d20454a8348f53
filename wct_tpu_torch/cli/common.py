"""Shared CLI plumbing: flags → CascadeConfig, device, weight loading.

The flags are those of ``wct_tpu/cli/common.py``, plus ``--device``.
``--preset`` keeps the JAX package's table except for ``pack2_junction``,
a rewrite for the TPU's 128 lanes that the throughput preset sets there
and that is not ported, and its precedence
(``wct_tpu/cli/common.py:203-220``): a preset overwrites ``--dtype`` and
``--method``, and an explicit ``--[no-]compose-conv0`` still wins over
it. ``--checkpoints`` with ``--vgg-path`` reads one decoder file per
level and the encoder from another, as the reference's ``load_params``
does (``:243-275``).
"""

from __future__ import annotations

import argparse

from wct_tpu_torch.models import cascade
from wct_tpu_torch.tools.make_bundle import validate_decoder
from wct_tpu_torch.train import checkpoint
from wct_tpu_torch.utils.device import resolve_device


def add_model_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--weights",
        default=None,
        help="npz bundle with {'encoder':..., 'decoders': {relu_target: ...}} "
        "(e.g. weights/bundle.npz). Omit for random weights (smoke tests).",
    )
    p.add_argument(
        "--checkpoints",
        nargs="+",
        default=None,
        help="per-level decoder npz files, one per --relu-targets entry in "
        "the same order (reference stylize.py --checkpoints, which took "
        "one TF checkpoint dir per level — convert those with "
        "tools/convert_tf_ckpt first). Alternative to a --weights bundle; "
        "needs --vgg-path for the encoder.",
    )
    p.add_argument(
        "--vgg-path",
        default=None,
        help="encoder weights npz (reference --vgg-path took the t7; "
        "convert it once with tools/convert_t7). Used with --checkpoints.",
    )
    p.add_argument(
        "--relu-targets",
        nargs="+",
        default=list(cascade.DEFAULT_TARGETS),
        help="cascade order, deepest first",
    )
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--passes", type=int, default=1)
    p.add_argument("--adain", action="store_true", help="AdaIN instead of WCT")
    p.add_argument("--swap5", action="store_true", help="style-swap at relu5_1")
    p.add_argument("--ss-alpha", type=float, default=0.6)
    p.add_argument("--ss-patch-size", type=int, default=3)
    p.add_argument("--ss-stride", type=int, default=1)
    p.add_argument(
        "--method",
        choices=[
            "eigh", "newton_schulz", "newton_schulz_fast",
            "newton_schulz_pallas", "auto",
        ],
        default="eigh",
        help="matrix-sqrt path for WCT: eigh, Newton-Schulz "
        "in plain PyTorch, newton_schulz_fast (the same with the cheapest "
        "product that still reaches rel err 5e-5, the throughput choice), "
        "Newton-Schulz through the CUDA kernel (newton_schulz_pallas, the "
        "name the JAX package gives it), or auto (eigh up to 64 channels, "
        "Newton-Schulz above)",
    )
    p.add_argument(
        "--dtype",
        choices=["float32", "bfloat16"],
        default="float32",
        help="conv compute dtype (bfloat16 = throughput mode)",
    )
    p.add_argument(
        "--conv-precision",
        choices=["highest", "high"],
        default="highest",
        help="kept for the JAX package's command lines: both values run "
        "float32 convs in full float32 here (cuDNN has no three-pass "
        "mode, and TF32 would be a different result). Ignored for "
        "--dtype bfloat16",
    )
    p.add_argument(
        "--soft-trunc",
        action="store_true",
        help="continuous eigenvalue filter instead of the hard 1e-5 "
        "truncation (batch-stable on rank-deficient features; default "
        "is exact reference behavior)",
    )
    p.add_argument(
        "--rel-trunc",
        type=float,
        default=None,
        metavar="R",
        help="RELATIVE eigenvalue threshold: keep modes with "
        "s > R*s_max instead of the reference's absolute 1e-5. The "
        "cross-solver-reproducible truncation mode: at R=1e-3 the keep "
        "mask of an f32 eigh matches a float64 one. Requires --method "
        "eigh; exclusive with --soft-trunc",
    )
    p.add_argument(
        "--wct-groups",
        type=int,
        default=1,
        help="grouped (block-diagonal) WCT: split channels into G "
        "independent groups (1 = exact reference WCT)",
    )
    p.add_argument(
        "--fold",
        action=argparse.BooleanOptionalAction,
        default=None,
        help="fold the per-image WCT/AdaIN affine into the decoder's "
        "first conv at every level up to 128 channels (relu2_1, relu1_1), "
        "which then runs as one grouped conv with per-image weights; no "
        "preset enables it",
    )
    p.add_argument(
        "--ring-conv",
        action="store_true",
        help="reflect convs without a padded copy: the bulk of every "
        "encoder and decoder conv runs zero-padded (SAME) and the "
        "one-pixel border is recomputed from thin reflect-padded strips. "
        "The same math",
    )
    p.add_argument(
        "--preset",
        choices=sorted(PRESETS),
        default=None,
        help="quality/speed preset setting --dtype, --method and "
        "--compose-conv0 (it overwrites --dtype and --method; an explicit "
        "--[no-]compose-conv0 wins over it): "
        "fidelity = f32 + eigh (reference-exact truncation), balanced = "
        "f32 convs + auto solver, throughput = bf16 + fast Newton-Schulz "
        "+ composed conv0",
    )
    p.add_argument(
        "--ns-iters",
        default=None,
        help="Newton-Schulz iteration override for the content-side "
        "whitening solve: an int for every level ('10') or per-level "
        "pairs ('relu5_1=12,relu1_1=8'; unlisted levels keep 14)",
    )
    p.add_argument(
        "--compose-conv0",
        action=argparse.BooleanOptionalAction,
        default=None,
        help="fold the encoder's linear 1x1 preprocessing conv0 into "
        "conv1_1 (identical math, one full-resolution conv fewer). The "
        "throughput preset enables it; --no-compose-conv0 opts out",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device to run on (default cuda; 'cpu' runs the plain "
        "PyTorch versions of the kernels)",
    )


def _parse_ns_iters(spec):
    """'10' → 10; 'relu5_1=12,relu1_1=8' → (('relu5_1', 12), ('relu1_1', 8))."""
    if spec is None or spec == "":
        return None
    s = str(spec)
    if "=" not in s:
        try:
            return int(s)
        except ValueError:
            raise SystemExit(
                f"--ns-iters: expected an int or 'reluN_1=K,...', got {s!r}"
            )
    pairs = []
    for part in s.split(","):
        if "=" not in part:
            raise SystemExit(f"--ns-iters: bad pair {part!r} in {s!r}")
        target, _, val = part.partition("=")
        try:
            pairs.append((target.strip(), int(val)))
        except ValueError:
            raise SystemExit(f"--ns-iters: bad count in {part!r}")
    return tuple(pairs)


# preset → (dtype, method, compose_conv0), the JAX package's table
# (``wct_tpu/cli/common.py:198-202``) without its fold and pack2 columns.
PRESETS = {
    "fidelity": ("float32", "eigh", False),
    "balanced": ("float32", "auto", False),
    "throughput": ("bfloat16", "newton_schulz_fast", True),
}


def config_from_args(args: argparse.Namespace) -> cascade.CascadeConfig:
    dtype, method, compose0 = args.dtype, args.method, False
    if args.preset:
        dtype, method, compose0 = PRESETS[args.preset]
    return cascade.CascadeConfig(
        relu_targets=tuple(args.relu_targets),
        transform="adain" if args.adain else "wct",
        swap5=args.swap5,
        ss_alpha=args.ss_alpha,
        ss_patch_size=args.ss_patch_size,
        ss_stride=args.ss_stride,
        passes=args.passes,
        method=method,
        compute_dtype=dtype,
        conv_precision=args.conv_precision,
        wct_groups=args.wct_groups,
        soft_trunc=args.soft_trunc,
        rel_trunc=args.rel_trunc,
        ns_iters=_parse_ns_iters(args.ns_iters),
        fold_transform=bool(args.fold),
        ring_conv=args.ring_conv,
        compose_conv0=compose0 if args.compose_conv0 is None else args.compose_conv0,
    )


def load_params(args: argparse.Namespace) -> dict:
    """Load the weight bundle, or per-level checkpoints, onto
    ``args.device``, or random-init there."""
    targets = tuple(args.relu_targets)
    device = resolve_device(args.device)
    ckpts = args.checkpoints
    if ckpts:
        # One decoder file per --relu-targets entry, paired by position,
        # each checked in its files' own HWIO layout before it is moved.
        if args.weights:
            raise SystemExit("--checkpoints and --weights are exclusive")
        if len(ckpts) != len(targets):
            raise SystemExit(
                f"--checkpoints got {len(ckpts)} files for "
                f"{len(targets)} --relu-targets; they pair by position"
            )
        if not args.vgg_path:
            raise SystemExit("--checkpoints needs --vgg-path for the encoder")
        enc = checkpoint.load_pytree(args.vgg_path)
        decoders = {}
        for t, path in zip(targets, ckpts):
            tree = checkpoint.load_pytree(path)
            tree = tree["params"] if "params" in tree else tree
            try:
                validate_decoder(tree, t)
            except ValueError as e:
                raise SystemExit(
                    f"--checkpoints {path} is not a {t} decoder: {e}"
                ) from e
            decoders[t] = tree
        params = {"encoder": enc["encoder"] if "encoder" in enc else enc,
                  "decoders": decoders}
        return checkpoint.params_from_numpy(params, device)
    if args.weights:
        params = checkpoint.load_pytree(args.weights)
        missing = [t for t in targets if t not in params.get("decoders", {})]
        if "encoder" not in params or missing:
            raise SystemExit(
                f"weight bundle {args.weights} lacks encoder or decoders "
                f"for {missing}"
            )
        params["decoders"] = {t: params["decoders"][t] for t in targets}
        return checkpoint.params_from_numpy(params, device)
    print(
        "[wct_tpu_torch] NOTE: no --weights given — using RANDOM weights "
        "(pipeline smoke test, not a meaningful stylization)"
    )
    return cascade.init_params(0, targets, device)
