"""Shared CLI plumbing: flags → CascadeConfig, device, weight loading.

The flags are those of ``wct_tpu/cli/common.py`` that this slice
supports, plus ``--device``.
"""

from __future__ import annotations

import argparse

from wct_tpu_torch.models import cascade
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
        "--relu-targets",
        nargs="+",
        default=list(cascade.DEFAULT_TARGETS),
        help="cascade order, deepest first",
    )
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--passes", type=int, default=1)
    p.add_argument(
        "--method",
        choices=["eigh", "newton_schulz", "newton_schulz_pallas", "auto"],
        default="eigh",
        help="matrix-sqrt path for WCT: eigh, Newton-Schulz in plain "
        "PyTorch, Newton-Schulz through the CUDA kernel "
        "(newton_schulz_pallas, the name the JAX package gives it), or "
        "auto (eigh up to 64 channels, Newton-Schulz above)",
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
        action="store_true",
        help="fold the encoder's linear 1x1 preprocessing conv0 into conv1_1",
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


def config_from_args(args: argparse.Namespace) -> cascade.CascadeConfig:
    return cascade.CascadeConfig(
        relu_targets=tuple(args.relu_targets),
        passes=args.passes,
        method=args.method,
        ns_iters=_parse_ns_iters(args.ns_iters),
        compose_conv0=args.compose_conv0,
    )


def load_params(args: argparse.Namespace) -> dict:
    """Load the weight bundle onto ``args.device``, or random-init there."""
    targets = tuple(args.relu_targets)
    device = resolve_device(args.device)
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
