"""The plain reference of the five-level WCT cascade.

Straight PyTorch, written from the method (Li et al., "Universal Style
Transfer via Feature Transforms", NeurIPS 2017) and the configuration
file, not from the program under test: it imports nothing of the
program. It reads the same weight bundle (``weights/bundle.npz``: HWIO
arrays under ``encoder/<conv>/{w,b}`` and ``decoders/<target>/<conv>/
{w,b}``) and the same input images, and works out everything else
again: the style statistics, each level's encoder, transform and
decoder, the final clip.

The model, level by level, from relu5_1 to relu1_1 (``CascadeConfig``'s
defaults, ``clip_between_levels=False``):

- encode the running RGB image with VGG-19 (a 1×1 preprocessing conv,
  reflect-padded 3×3 convs with ReLU, 2×2 max pools) up to the level;
- WCT against the style's statistics at the same level:
  ``cov = (f−μ)(f−μ)ᵀ/(N−1) + 1e-8·I``, whitening ``cov_c^{−1/2}``,
  colouring ``cov_s^{1/2}``, blend ``α·(T(f−μ_c) + μ_s) + (1−α)·f``;
  the matrix powers by ``eigh`` with eigenvalues ≤ 1e-5 dropped, or by
  the coupled Newton–Schulz iteration (14 steps, a 1e-5·tr/C floor)
  where the configuration states ``newton_schulz*``;
- decode with the level's mirrored decoder (nearest 2× upsampling,
  reflect 3×3 convs with ReLU, the last conv linear);
- after the last level clip to [0, 1].

``precision`` says in what the products are computed: ``float64``
(the yardstick), ``float32`` (TF32 off), or a lower one by rounding
every product's operands and every stored activation to it, with f32
sums: ``tf32`` (10 explicit mantissa bits), ``bfloat16``, ``fp8``
(e4m3 with one scale per tensor, its largest magnitude at 448). The
lower ones are the controls of ``correct``: the reference computed one
step below the configuration's precision must come out not correct.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

ENCODER = (
    ("conv0", 3, 3, 1),
    ("conv1_1", 3, 64, 3), ("conv1_2", 64, 64, 3), ("pool",),
    ("conv2_1", 64, 128, 3), ("conv2_2", 128, 128, 3), ("pool",),
    ("conv3_1", 128, 256, 3), ("conv3_2", 256, 256, 3), ("conv3_3", 256, 256, 3),
    ("conv3_4", 256, 256, 3), ("pool",),
    ("conv4_1", 256, 512, 3), ("conv4_2", 512, 512, 3), ("conv4_3", 512, 512, 3),
    ("conv4_4", 512, 512, 3), ("pool",),
    ("conv5_1", 512, 512, 3),
)
LEVEL_CONV = {"relu1_1": "conv1_1", "relu2_1": "conv2_1", "relu3_1": "conv3_1",
              "relu4_1": "conv4_1", "relu5_1": "conv5_1"}
EPS = 1e-8
TRUNC = 1e-5
NS_ITERS = 14
NS_REG = 1e-5
PRECISIONS = ("float64", "float32", "tf32", "bfloat16", "fp8")


def encoder_layers(level: str) -> list[tuple]:
    """The encoder's layers from RGB up to ``level``'s conv (its ReLU last)."""
    end = next(i for i, l in enumerate(ENCODER) if l[0] == LEVEL_CONV[level])
    return list(ENCODER[: end + 1])


def decoder_layers(level: str) -> list[tuple]:
    """The mirrored decoder of ``level``: ``("up",)`` or ``(name, cin, cout)``."""
    out = []
    for layer in reversed(encoder_layers(level)):
        if layer[0] == "pool":
            out.append(("up",))
        elif layer[0] != "conv0":
            name, cin, cout, _ = layer
            out.append((f"dec_{name}", cout, cin))
    return out


def load_bundle(path) -> dict:
    """``{"encoder": {conv: (w OIHW, b)}, "decoders": {level: {conv: (w, b)}}}``
    as float64 CPU tensors, from the HWIO arrays of the bundle."""
    params: dict = {"encoder": {}, "decoders": {}}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split("/")
            if parts[-1] != "w":
                continue
            w = torch.from_numpy(z[key].astype(np.float64)).permute(3, 2, 0, 1).contiguous()
            b = torch.from_numpy(z["/".join(parts[:-1] + ["b"])].astype(np.float64))
            if parts[0] == "encoder":
                params["encoder"][parts[1]] = (w, b)
            else:
                params["decoders"].setdefault(parts[1], {})[parts[2]] = (w, b)
    return params


def params_to(params: dict, device, dtype) -> dict:
    return {
        "encoder": {k: (w.to(device, dtype), b.to(device, dtype))
                    for k, (w, b) in params["encoder"].items()},
        "decoders": {lv: {k: (w.to(device, dtype), b.to(device, dtype)) for k, (w, b) in d.items()}
                     for lv, d in params["decoders"].items()},
    }


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    scale = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    """The cascade in one ``precision``, on ``device``, from ``params``
    (``load_bundle``'s tree). ``method`` is the configuration's: ``eigh``
    or a Newton–Schulz one; ``levels`` its relu targets in cascade order;
    ``config`` the configuration's file, for a variant's own parameters.

    A configuration whose transform is not the plain WCT names a variant
    (``"reference": "<name>"``): a subclass in ``references/<name>.py``
    that overrides the per-level hooks ``style_state``, ``transform``,
    ``statistics`` and, for numbers of its own, ``extra_readings``."""

    def __init__(self, params: dict, device, precision: str = "float64",
                 method: str = "eigh", levels=("relu5_1", "relu4_1", "relu3_1", "relu2_1", "relu1_1"),
                 config: dict | None = None):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.config = config or {}
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.method = method
        self.levels = tuple(levels)
        self.device = torch.device(device)
        self.params = params_to(params, self.device, self.dtype)

    # -- numerics ------------------------------------------------------------
    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` rounded to the precision's storage (the identity for the
        float64 and float32 references)."""
        if self.precision == "tf32":
            return _round_tf32(x)
        if self.precision == "bfloat16":
            return x.to(torch.bfloat16).to(torch.float32)
        if self.precision == "fp8":
            return _round_fp8(x)
        return x

    def _no_tf32(self):
        prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)

        class _Ctx:
            def __enter__(ctx):
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False

            def __exit__(ctx, *exc):
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev

        return _Ctx()

    def conv(self, x, wb, relu: bool):
        w, b = wb
        k = w.shape[-1]
        if k > 1:
            x = F.pad(x, (k // 2,) * 4, mode="reflect")
        y = F.conv2d(self.q(x), self.q(w), b)
        return self.q(torch.relu(y) if relu else y)

    def matmul(self, a, b):
        return self.q(a) @ self.q(b)

    # -- the model -------------------------------------------------------------
    def encode(self, img_nchw: torch.Tensor, level: str) -> torch.Tensor:
        x = img_nchw
        for layer in encoder_layers(level):
            if layer[0] == "pool":
                x = F.max_pool2d(x, 2)
            else:
                x = self.conv(x, self.params["encoder"][layer[0]], relu=layer[0] != "conv0")
        return x

    def decode(self, f: torch.Tensor, level: str) -> torch.Tensor:
        x = f
        layers = decoder_layers(level)
        for i, layer in enumerate(layers):
            if layer[0] == "up":
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            else:
                x = self.conv(x, self.params["decoders"][level][layer[0]], relu=i != len(layers) - 1)
        return x

    def covariance(self, f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``f [C, N]`` → (``(f−μ)(f−μ)ᵀ/(N−1)``, ``μ``)."""
        mean = f.mean(dim=1)
        c = f - mean[:, None]
        return self.matmul(c, c.T) / (f.shape[1] - 1), mean

    def powers(self, cov: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(cov^{1/2}, cov^{−1/2}) of ``cov + 1e-8·I`` by the method."""
        c = cov.shape[0]
        eye = torch.eye(c, dtype=cov.dtype, device=cov.device)
        a = cov + EPS * eye
        if self.method == "eigh":
            s, u = torch.linalg.eigh(a)
            keep = s > TRUNC
            sq = torch.where(keep, s.clamp_min(TRUNC).sqrt(), 0.0)
            isq = torch.where(keep, 1.0 / s.clamp_min(TRUNC).sqrt(), 0.0)
            return (u * sq) @ u.T, (u * isq) @ u.T
        a = a + NS_REG * torch.trace(a) / c * eye
        norm = a.abs().sum(dim=1).max()
        y, z = a / norm, eye
        for _ in range(NS_ITERS):
            t = 1.5 * eye - 0.5 * (z @ y)
            y, z = y @ t, t @ z
        return y * norm.sqrt(), z / norm.sqrt()

    @torch.no_grad()
    def style_stats(self, style_hwc) -> dict:
        """Per level what the level's transform keeps of one style image
        (``style_state``)."""
        with self._no_tf32():
            img = self._nchw(style_hwc)
            return {level: self.style_state(level, self.encode(img, level)[0].flatten(1))
                    for level in self.levels}

    def style_state(self, level: str, f: torch.Tensor):
        """What ``transform`` at ``level`` needs of the style's features
        ``f [C, N]``: for the WCT ``(colouring matrix [C, C], mean [C])``."""
        cov, mean = self.covariance(f.to(torch.float64) if self.dtype == torch.float64 else f)
        return self.powers(cov)[0], mean

    def statistics(self, level: str, state) -> dict:
        """``state`` under the names the program's style cache gives the same
        statistics (``harness/program.py::style_statistics``); a colouring
        is ``stats.kernel`` and ``stats.mean``."""
        k, mu = state
        return {"stats.kernel": k, "stats.mean": mu}

    def extra_readings(self, got: dict, want: dict) -> dict:
        """Numbers of a variant's own for ``correct``, from the program's
        style statistics ``got`` and this reference's ``want`` (``{level:
        statistics}``, float64 on the host); a number the program's
        statistics cannot give is left out, and a limit on it is then not
        correct. The plain WCT adds none."""
        return {}

    @torch.no_grad()
    def style_features(self, style_hwc, levels=None) -> dict:
        """Per level (by default every one) the style's features ``[C, N]``
        and their whitened form (``cov_s^{−1/2}(f − μ_s)`` by the method),
        for judging a colouring by what it does to the style's own
        features."""
        with self._no_tf32():
            img = self._nchw(style_hwc)
            out = {}
            for level in self.levels if levels is None else levels:
                f = self.encode(img, level)[0].flatten(1)
                cov, mean = self.covariance(f)
                out[level] = (f, self.matmul(self.powers(cov)[1], f - mean[:, None]))
            return out

    def transform(self, level: str, f: torch.Tensor, state, alpha: float) -> torch.Tensor:
        """One image's features ``[C, H, W]`` at ``level`` through the
        level's transform against the style's ``state``: the WCT."""
        return self.wct(f, state, alpha)

    def wct(self, f: torch.Tensor, stats, alpha: float) -> torch.Tensor:
        """One image's features ``[C, H, W]`` through the WCT against ``stats``."""
        c, h, w = f.shape
        x = f.flatten(1)
        cov, mu_c = self.covariance(x)
        white = self.powers(cov)[1]
        k_s, mu_s = stats
        colored = self.matmul(self.matmul(k_s, white), x - mu_c[:, None]) + mu_s[:, None]
        return self.q(alpha * colored + (1.0 - alpha) * x).reshape(c, h, w)

    @torch.no_grad()
    def stylize(self, content_hwc, stats: dict, alpha: float) -> torch.Tensor:
        """One image ``[H, W, 3]`` in [0, 1] → ``[H, W, 3]`` float64 in [0, 1]
        on the reference's device."""
        with self._no_tf32():
            x = self._nchw(content_hwc)
            h, w = x.shape[-2:]
            mult = 16
            ph, pw = (-h) % mult, (-w) % mult
            if ph or pw:
                x = F.pad(x, (0, pw, 0, ph), mode="reflect")
            for level in self.levels:
                f = self.encode(x, level)
                f = self.transform(level, f[0], stats[level], alpha)[None]
                x = self.decode(f, level)
            return x[0, :, :h, :w].clamp(0.0, 1.0).permute(1, 2, 0).to(torch.float64)

    def _nchw(self, img_hwc) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(img_hwc)) if not torch.is_tensor(img_hwc) else img_hwc
        if t.dtype == torch.uint8:
            t = t.to(torch.float64) / 255.0
        return self.q(t.to(self.device, self.dtype).permute(2, 0, 1)[None].contiguous())
