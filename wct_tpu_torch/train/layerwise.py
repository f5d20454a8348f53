"""Closed-form decoder initialization by layerwise ridge inversion.

Counterpart of ``wct_tpu/train/layerwise.py``. Every decoder conv is the
mirror of one encoder conv, and each mirror conv is LINEAR in its input
patches, so its MSE-optimal weights given the input it sees at init
(teacher-forced encoder activations) are a ridge solve:

    minimize  ||P w − Y||² + λ‖w‖²   ⇒   w = (PᵀP + λI)⁻¹ PᵀY

with ``P`` the reflect-padded 3×3 patch matrix of the conv's input and
``Y`` the activation it must reproduce. Thirteen regressions cover all
five decoders (shared mirrors are solved once):

- the mirror of conv ``c`` regresses ``c``'s input activation from
  patches of ``c``'s output activation;
- when the encoder pools right after ``c``, the decoder sees the 2×
  nearest-upsampled pooled map, so that is the regression input;
- the mirror of conv1_1 regresses the RGB image itself.

Numerics: ``PᵀP`` and ``PᵀY`` accumulate in full f32 (no TF32, as the
JAX package's ``Precision.HIGHEST``), in place into the accumulators
(where the JAX package donates them); the solves run on the host in
float64, since the 4609² normal matrices are ill-conditioned. Patch
columns are ordered (kh, kw, in), so a solved weight reshapes to
``[k, k, x_c, y_c]`` (HWIO) before it turns into the port's OIHW. At 512
channels one G is 4609² f32, 85 MB on the device.

Public functions take and return ``[B, H, W, C]`` activations, as the JAX
package's do.
"""

from __future__ import annotations

import numpy as np
import torch

from wct_tpu_torch.models import decoder as dec_lib
from wct_tpu_torch.models import vgg
from wct_tpu_torch.ops.convs import (
    conv2d_reflect_nchw,
    maxpool2_nchw,
    pad_reflect,
    to_nchw,
    to_nhwc,
    upsample_nearest2,
    upsample_nearest2_nchw,
)
from wct_tpu_torch.utils.device import resolve_device, set_fp32_numerics


def encoder_trace(enc_params: dict, x: torch.Tensor) -> dict[str, torch.Tensor]:
    """All named encoder activations for ``x`` ``[B, H, W, 3]`` in [0, 1].

    Returns {"input": x, conv_name: post-ReLU activation (post-linear
    for conv0), pool_name: pooled map}, each ``[B, h, w, C]``.
    """
    acts: dict[str, torch.Tensor] = {"input": x}
    h = to_nchw(x)
    for spec in vgg.ENCODER_LAYERS:
        kind, name = spec[0], spec[1]
        if kind == "pool":
            h = maxpool2_nchw(h)
        else:
            p = enc_params[name]
            h = conv2d_reflect_nchw(h, p["w"], p["b"])
            if kind != "conv_pre":
                h = torch.relu(h)
        acts[name] = to_nhwc(h)
    return acts


def regression_specs() -> list[dict]:
    """One spec per decoder conv: name, d (patch+bias), in/out dims and
    which traced activations form (X, Y) — see module docstring."""
    specs = []
    layers = vgg.ENCODER_LAYERS
    for i, spec in enumerate(layers):
        if spec[0] != "conv":
            continue
        _, name, in_c, out_c, k = spec
        pooled = i + 1 < len(layers) and layers[i + 1][0] == "pool"
        prev = layers[i - 1]
        y_key = "input" if prev[0] == "conv_pre" else prev[1]
        y_c = 3 if y_key == "input" else in_c
        specs.append({
            "conv": name,
            "dec": f"dec_{name}",
            "x_key": name,
            "x_pooled": pooled,
            "pool_key": layers[i + 1][1] if pooled else None,
            "y_key": y_key,
            "x_c": out_c,
            "y_c": y_c,
            "k": k,
            "d": k * k * out_c + 1,
        })
    return specs


def _patches(x: torch.Tensor, k: int) -> torch.Tensor:
    """[B,H,W,C] → [B·H·W, k·k·C+1] reflect-padded patches + ones column,
    ordered (kh, kw, in) to match the conv kernel layout [kh,kw,in,out]."""
    b, h, w, c = x.shape
    xp = pad_reflect(x, k // 2)
    cols = [xp[:, dy : dy + h, dx : dx + w, :] for dy in range(k) for dx in range(k)]
    pm = torch.stack(cols, dim=3).reshape(b * h * w, k * k * c)
    return torch.cat([pm, torch.ones(pm.shape[0], 1, dtype=pm.dtype, device=pm.device)], dim=1)


def _zeros(s: dict, device) -> dict:
    return {
        "G": torch.zeros(s["d"], s["d"], dtype=torch.float32, device=device),
        "b": torch.zeros(s["d"], s["y_c"], dtype=torch.float32, device=device),
    }


def init_stats(specs: list[dict], device: str | torch.device = "cuda") -> dict:
    """Zeroed (G, b) accumulators, f32, one pair per regression."""
    dev = resolve_device(device)
    return {s["dec"]: _zeros(s, dev) for s in specs}


def _accumulate(g: dict, P: torch.Tensor, Y: torch.Tensor) -> None:
    g["G"].addmm_(P.mT, P)
    g["b"].addmm_(P.mT, Y)


def _normalized(batch: torch.Tensor) -> torch.Tensor:
    x = batch.to(torch.float32)
    return x / 255.0 if batch.dtype == torch.uint8 else x


@torch.no_grad()
def accumulate_stats(
    stats: dict, enc_params: dict, batch: torch.Tensor, subsample: int = 0
) -> dict:
    """One statistics pass: add every regression's ``PᵀP`` and ``PᵀY``
    into ``stats`` in place, and return it.

    ``batch``: ``[B, H, W, 3]`` float or uint8 (divided by 255 on its
    device, as the trainer does). ``subsample > 0``: only every
    ``subsample``-th patch row feeds the full-resolution regressions
    (the 64-channel ones, whose Grams are 577² and converge on far fewer
    rows).
    """
    set_fp32_numerics()
    acts = encoder_trace(enc_params, _normalized(batch))
    for s in regression_specs():
        xin = acts[s["x_key"]]
        if s["x_pooled"]:
            xin = upsample_nearest2(acts[s["pool_key"]])
        y = acts[s["y_key"]]
        P = _patches(xin, s["k"])
        Y = y.reshape(-1, y.shape[-1])
        if subsample and s["x_c"] <= 64:
            P, Y = P[::subsample], Y[::subsample]
        _accumulate(stats[s["dec"]], P, Y)
    return stats


@torch.no_grad()
def accumulate_refit_stats(
    stats: dict,
    enc_params: dict,
    dec_params: dict,
    batch: torch.Tensor,
    target: str,
    subsample: int = 0,
    only: str | None = None,
) -> dict:
    """Decoder-FORCED statistics pass for one level's refit, in place.

    Walks the actual decoder with ``dec_params`` (OIHW), accumulating each
    conv's (G, b) against its teacher target, so each solve sees the
    input the previous solved conv gives it. ``only=<conv name>`` stops at
    that conv (a Gauss–Seidel sweep: solve and update it before the next
    conv's pass); ``only=None`` accumulates every conv of the level
    (Jacobi). ``stats`` holds only this level's conv names (or ``only``'s).
    """
    set_fp32_numerics()
    acts = encoder_trace(enc_params, _normalized(batch))
    by_dec = {s["dec"]: s for s in regression_specs()}
    layers = dec_lib.decoder_layers(target)
    h = to_nchw(acts[f"conv{target[4]}_1"])  # the level's code, teacher-forced
    for i, spec in enumerate(layers):
        if spec[0] == "upsample":
            h = upsample_nearest2_nchw(h)
            continue
        _, name, in_c, out_c, k = spec
        if only is None or name == only:
            y = acts[by_dec[name]["y_key"]]
            P = _patches(to_nhwc(h), k)
            Y = y.reshape(-1, y.shape[-1])
            if subsample and in_c <= 64:
                P, Y = P[::subsample], Y[::subsample]
            _accumulate(stats[name], P, Y)
            if name == only:  # Gauss–Seidel: the rest of the walk is unused
                return stats
        p = dec_params[name]
        h = conv2d_reflect_nchw(h, p["w"], p["b"])
        if i + 1 < len(layers):  # the final conv is linear (RGB)
            h = torch.relu(h)
    return stats


def init_refit_stats(
    target: str, only: str | None = None, device: str | torch.device = "cuda"
) -> dict:
    """Zeroed refit accumulators for one level's decoder convs
    (or just ``only``'s, for a Gauss–Seidel sweep)."""
    dev = resolve_device(device)
    by_dec = {s["dec"]: s for s in regression_specs()}
    return {
        name: _zeros(by_dec[name], dev)
        for kind, name, *_ in dec_lib.decoder_layers(target)
        if kind == "conv" and (only is None or name == only)
    }


def solve_ridge(G, b, lam: float = 1e-4) -> np.ndarray:
    """Host float64 ridge solve; λ scales with mean diagonal energy."""
    G = _host64(G)
    b = _host64(b)
    d = G.shape[0]
    reg = lam * (np.trace(G) / d)
    return np.linalg.solve(G + reg * np.eye(d), b)


def _host64(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def _conv_params(w: np.ndarray, s: dict, device: torch.device) -> dict:
    """A solved ``[d, y_c]`` regression as the port's conv: OIHW weight, bias."""
    kern = w[:-1].reshape(s["k"], s["k"], s["x_c"], s["y_c"]).transpose(3, 2, 0, 1)
    return {
        "w": torch.tensor(np.ascontiguousarray(kern), dtype=torch.float32, device=device),
        "b": torch.tensor(w[-1], dtype=torch.float32, device=device),
    }


def solve_refit(
    stats: dict, target: str, lam: float = 1e-4, device: str | torch.device = "cuda"
) -> dict:
    """Solve one level's refit stats into a decoder param tree on ``device``."""
    dev = resolve_device(device)
    by_dec = {s["dec"]: s for s in regression_specs()}
    return {
        name: _conv_params(solve_ridge(gb["G"], gb["b"], lam), by_dec[name], dev)
        for name, gb in stats.items()
    }


def solved_decoder_params(
    stats: dict, lam: float = 1e-4, verbose: bool = True,
    device: str | torch.device = "cuda",
) -> dict:
    """Solve every regression and assemble per-level decoder trees.

    Returns {relu_target: {dec_conv*: {"w", "b"}}} on ``device``, with
    mirror convs shared by value across levels (independent copies).
    """
    dev = resolve_device(device)
    solved: dict[str, dict] = {}
    for s in regression_specs():
        w = solve_ridge(stats[s["dec"]]["G"], stats[s["dec"]]["b"], lam)
        solved[s["dec"]] = _conv_params(w, s, dev)
        if verbose:
            print(f"  solved {s['dec']}: d={s['d']} -> out {s['y_c']}")
    return {
        t: {
            name: {"w": solved[name]["w"].clone(), "b": solved[name]["b"].clone()}
            for kind, name, *_ in dec_lib.decoder_layers(t)
            if kind == "conv"
        }
        for t in vgg.RELU_TARGETS
    }
