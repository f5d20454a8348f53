"""How ``correct`` is decided: the program's outputs against the plain
reference in float64, on the same inputs. The reference is the
configuration's (``reference_for``): ``harness/reference.py``'s WCT
cascade, or the variant its file names.

The numbers (``readings``); a cell compares those its limits file
(``limits/<cell>.json``) names, each against its limit, and a name the
readings do not hold is not correct:

- ``style_rel``: over the levels where both the program and the
  reference keep a colouring, the largest relative Frobenius gap of the
  program's cached colouring matrix and of its style mean from the
  reference's (absent where they share none);
- ``style_recolour_rel``: over the same levels, the largest relative gap
  between the style's own features and the program's colouring of their
  whitened form (``recolour_gap``);
- ``image_mean_abs``: over the sampled outputs, the largest mean |Δ| in
  uint8 steps between an output and the reference's image of the same
  input, quantised by the program's rule (clip, ×255, truncate);
- ``image_mean_abs_median``, ``image_mean_abs_q80``: the median and the
  80th percentile over the sampled outputs of the same (with every image
  of a pool checked, a fault in one slot of four in a microbatch spoils a
  quarter of them and moves the 80th percentile);
- ``image_q99_abs``: the largest 99th percentile of |Δ|;
- whatever numbers the variant adds (``Reference.extra_readings``).

An output is judged against the reference of the input the benchmark
sent for it, so an output handed back for another frame fails. Every
output due is either delivered or counted in ``failed``.
"""

from __future__ import annotations

import numpy as np
import torch

from harness import reference as ref_lib
from harness import spec
from harness.spec import ROOT

KERNEL, MEAN = "stats.kernel", "stats.mean"


def quantise(img: torch.Tensor) -> torch.Tensor:
    """The program's readback rule: ``(clip(x, 0, 1) · 255) → uint8``, truncating."""
    return (img.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def image_gap(got_u8: np.ndarray, ref: torch.Tensor) -> tuple[float, float]:
    """(mean |Δ|, q99 |Δ|) in uint8 steps of one output against the
    reference's float image on the reference's device."""
    want = quantise(ref).to(torch.int16)
    got = torch.as_tensor(got_u8, device=ref.device).to(torch.int16)
    d = (got - want).abs().float().flatten()
    q99 = torch.quantile(d[:: max(1, d.numel() // 2_000_000)], 0.99)
    return float(d.mean()), float(q99)


def reference_for(config: dict, device, precision: str = "float64",
                  params: dict | None = None) -> ref_lib.Reference:
    """The configuration's reference in ``precision`` on ``device``: the
    class ``Reference`` of ``references/<name>.py`` where the file names
    ``"reference": "<name>"``, else the plain WCT cascade."""
    cls = ref_lib.Reference
    if "reference" in config:
        cls = spec.reference_module(config["reference"]).Reference
        if not issubclass(cls, ref_lib.Reference):
            raise TypeError(f"references/{config['reference']}.py: Reference does not "
                            "subclass harness/reference.py's")
    return cls(params or ref_lib.load_bundle(ROOT / config["weights"]), device, precision,
               method=config["reference_method"], levels=config["relu_targets"], config=config)


def colourings(stats: dict) -> dict:
    """``{level: (colouring matrix, mean)}`` of the levels whose statistics
    (``{level: {name: tensor}}``) hold a colouring."""
    return {level: (s[KERNEL], s[MEAN]) for level, s in stats.items() if KERNEL in s}


def style_gap(got: dict, want: dict) -> float:
    """The largest relative Frobenius gap of the cached colouring matrices
    and means over the levels of ``want``."""
    worst = 0.0
    for level, (k, mu) in want.items():
        gk, gmu = got[level]
        k, mu = k.double().cpu(), mu.double().cpu()
        worst = max(worst, float((gk - k).norm() / k.norm()), float((gmu - mu).norm() / mu.norm()))
    return worst


def recolour_gap(got: dict, features: dict) -> float:
    """The largest, over the levels, relative gap between the style's own
    features and the program's colouring (``K·ŵ + μ``) of their whitened
    form ``ŵ`` (``Reference.style_features``): the colouring judged by
    what it does to the features it describes, each direction weighted by
    the style's variance along it."""
    worst = 0.0
    for level, (f, white) in features.items():
        k, mu = (t.to(white.device, torch.float64) for t in got[level])
        centred = f - f.mean(dim=1, keepdim=True)
        err = k @ white + mu[:, None] - f
        worst = max(worst, float(err.norm() / centred.norm()))
    return worst


def readings(config: dict, style_u8: np.ndarray, program_stats: dict,
             samples: list[tuple[int, np.ndarray]], pool, device, reference_params=None) -> dict:
    """Every number ``correct`` can compare, for the program's style
    statistics (``program.style_statistics``) and its sampled outputs
    (``(pool index, uint8 output)``, ``pool[index]`` the input sent),
    against the configuration's reference in float64 on ``device``. A
    cell compares those its limits file names."""
    ref = reference_for(config, device, "float64", reference_params)
    stats = ref.style_stats(style_u8)
    want = {lv: {k: t.double().cpu() for k, t in ref.statistics(lv, s).items()}
            for lv, s in stats.items()}
    have = colourings(program_stats)
    shared = {lv: kmu for lv, kmu in colourings(want).items() if lv in have}
    out = {}
    if shared:
        out["style_rel"] = style_gap(have, shared)
        out["style_recolour_rel"] = recolour_gap(have, ref.style_features(style_u8, list(shared)))
    out.update(ref.extra_readings(program_stats, want))
    gaps = [image_gap(got, ref.stylize(pool[index], stats, float(config["alpha"])))
            for index, got in samples]
    means = [m for m, _ in gaps] or [float("nan")]
    out["image_mean_abs"] = max(means)
    out["image_mean_abs_median"] = float(np.median(means))
    out["image_mean_abs_q80"] = float(np.quantile(means, 0.8))
    out["image_mean_abs_each"] = means
    out["image_q99_abs"] = max((q for _, q in gaps), default=float("nan"))
    return out


def judge(values: dict, limits: dict, failed: int, n_samples: int) -> tuple[bool, dict]:
    """``correct``, and each number compared beside its limit; a number
    the limits name and ``values`` lacks reads None and is not correct."""
    checks = {k: {"value": values.get(k), "limit": limits[k]} for k in limits}
    checks["failed"] = {"value": failed, "limit": 0}
    ok = n_samples > 0 and failed == 0 and all(
        c["value"] is not None and np.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    return bool(ok), checks


def control_readings(config: dict, traffic: dict, seed: int, device, precision: str | None = None,
                     reference_params=None) -> dict:
    """The numbers compared when the configuration's reference computed in
    ``precision`` (by default the configuration's ``control_precision``,
    one step below its own) takes the program's place, on the seed's style
    and on the first ``check_images`` inputs the seed's traffic sends."""
    from harness import drivers, inputs

    params = reference_params or ref_lib.load_bundle(ROOT / config["weights"])
    h, w = int(traffic["height"]), int(traffic["width"])
    style = drivers.style_image(config, seed, device)
    pool = inputs.images(int(traffic["pool_images"]), h, w, seed + 1, device).cpu().numpy()
    order = drivers.pool_order(len(pool), seed)
    low = reference_for(config, device, precision or config["control_precision"], params)
    stats = low.style_stats(style)
    samples = []
    for i in range(int(traffic["check_images"])):
        index = int(order[i % len(order)])
        out = low.stylize(pool[index], stats, float(config["alpha"]))
        samples.append((index, quantise(out).cpu().numpy()))
    got = {lv: {k: t.double().cpu() for k, t in low.statistics(lv, s).items()}
           for lv, s in stats.items()}
    del low
    return readings(config, style, got, samples, pool, device, params)
