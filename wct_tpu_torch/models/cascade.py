"""The multi-level stylization cascade.

Counterpart of ``wct_tpu/models/cascade.py``: content flows relu5_1 →
… → relu1_1; each level encodes the running image, applies the WCT at
``alpha`` against the cached style statistics, and decodes. The style
is encoded once (``precompute_style``, one trunk sweep for all levels).

Ported: the unpacked path in f32 and in bf16
(``compute_dtype='bfloat16'``: bf16 activations through every conv,
f32 statistics and kernels, f32 images in and out), unfused
(``cascade.py:526-557``, ``645-647``, ``705-715``) and with
``fuse_junction`` (``:474-476``, ``:545-547``, ``:609-644``,
``:648-704``), where the full-resolution segment between two levels
runs in the kernels of ``ops/junction.py`` in the activations' type
(bf16 ones round as the TPU kernels do, once per conv after the f32
bias: ``ops/junction.py`` says how that differs from the unfused bf16
conv). Each level's transform is the WCT (with any truncation mode and
``wct_groups``), AdaIN (``transform='adain'``), or at relu5_1 with
``swap5`` the style-swap; the fused relu1_1 tail folds the WCT's or
AdaIN's per-image affine into its conv. Several styles blend through
``interpolate_style_caches`` and ``stylize_interp``. ``fold_transform``
folds each image's affine into the first decoder conv at the levels of
up to 128 channels (``:570-607``), ``ring_conv`` runs every encoder
and decoder conv outside the fused kernels without a reflect-padded
copy (``ops/convs.py::conv2d_reflect_ring_nchw``), and ``pack2_junction``
(with its scopes ``pack2_tail_only`` and ``pack2_junction_only``) runs the
64-channel tier on image pairs (``ops/pack2.py``; ``:477-566``,
``:657-677``; even batches only). Every ``CascadeConfig`` field and check
is kept, so the same illegal combinations raise the same ``ValueError``.

PyTorch runs eagerly, so there is no jit; the models run NCHW
internally and the public functions take and return ``[B, H, W, 3]``
images. Everything runs on the device the parameters live on.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from wct_tpu_torch.models import decoder as dec_lib
from wct_tpu_torch.models import vgg
from wct_tpu_torch.ops import adain as adain_ops
from wct_tpu_torch.ops import junction as junction_ops
from wct_tpu_torch.ops import pack2
from wct_tpu_torch.ops import style_swap as swap_ops
from wct_tpu_torch.ops import wct as wct_ops
from wct_tpu_torch.ops.convs import to_nchw, to_nhwc
from wct_tpu_torch.utils.device import (
    params_device,
    resolve_device,
    scalar_on,
    set_numerics,
    values_on,
)
from wct_tpu_torch.utils.profiling import span

DEFAULT_TARGETS = ("relu5_1", "relu4_1", "relu3_1", "relu2_1", "relu1_1")
# Each level's span, named once so that a span costs no string per call.
_LEVEL_SPANS = {t: f"wct.level.{t}" for t in vgg.RELU_TARGETS}


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """Pipeline configuration; fields as ``wct_tpu``'s ``CascadeConfig``.

    ``relu_targets`` (cascade order), ``transform``, ``swap5`` (+ patch
    params), ``passes``, ``method`` (the matrix-sqrt path),
    ``compute_dtype`` and ``conv_precision``, ``clip_between_levels``,
    the truncation modes, ``ns_iters`` (content-side Newton–Schulz
    iterations: an int, or ``("reluN_1", iters)`` pairs), ``wct_groups``
    and the layout rewrites ``fold_transform``, ``fuse_junction``,
    ``pack2_*``, ``ring_conv`` and ``compose_conv0``. See the JAX
    package for what each does.

    ``conv_precision='high'`` is, in the JAX package, a three-pass bf16
    product that is f32-class (about 1e-6). cuDNN has no such mode, and
    TF32 (about 1e-3) would be a different result, so here ``'high'``
    runs the same full-f32 convs as ``'highest'``; under bf16 it is
    ignored, as in the JAX package.
    """

    relu_targets: tuple[str, ...] = DEFAULT_TARGETS
    transform: str = "wct"  # 'wct' | 'adain'
    swap5: bool = False
    ss_alpha: float = 0.6
    ss_patch_size: int = 3
    ss_stride: int = 1
    passes: int = 1
    method: wct_ops.Method = "eigh"
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    conv_precision: str = "highest"  # 'highest' | 'high'
    # False = reference semantics: clip once, before saving.
    clip_between_levels: bool = False
    soft_trunc: bool = False
    rel_trunc: float | None = None
    ns_iters: int | tuple[tuple[str, int], ...] | None = None
    wct_groups: int = 1
    fold_transform: bool = False
    fuse_junction: bool = False
    pack2_junction: bool = False
    pack2_tail_only: bool = False
    pack2_junction_only: bool = False
    ring_conv: bool = False
    compose_conv0: bool = False

    def __post_init__(self):
        bad = [t for t in self.relu_targets if t not in vgg.RELU_TARGETS]
        if bad or not self.relu_targets:
            raise ValueError(
                f"invalid relu_targets {bad or self.relu_targets}; "
                f"choose from {vgg.RELU_TARGETS}"
            )
        if len(set(self.relu_targets)) != len(self.relu_targets):
            raise ValueError(f"duplicate relu_targets {self.relu_targets}")
        if self.transform not in ("wct", "adain"):
            raise ValueError(f"transform must be 'wct'|'adain', got {self.transform!r}")
        if self.swap5 and "relu5_1" not in self.relu_targets:
            raise ValueError(
                "swap5=True but 'relu5_1' is not in relu_targets — the swap "
                "level would never run"
            )
        if self.passes < 1:
            raise ValueError(f"passes must be >= 1, got {self.passes}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")
        if self.conv_precision not in ("highest", "high"):
            raise ValueError(f"conv_precision {self.conv_precision!r}")
        if self.method not in (
            "eigh", "newton_schulz", "newton_schulz_fast",
            "newton_schulz_pallas", "auto",
        ):
            raise ValueError(f"unknown method {self.method!r}")
        if self.wct_groups < 1 or any(
            vgg.TARGET_CHANNELS[t] % self.wct_groups for t in self.relu_targets
        ):
            raise ValueError(
                f"wct_groups={self.wct_groups} must divide every level's "
                f"channel count "
                f"({ {t: vgg.TARGET_CHANNELS[t] for t in self.relu_targets} })"
            )
        if self.fuse_junction and self.fold_transform:
            raise ValueError(
                "fuse_junction and fold_transform are mutually exclusive "
                "(the junction kernel replaces the decoder tail the fold "
                "would rewrite)"
            )
        if self.rel_trunc is not None:
            if self.soft_trunc:
                raise ValueError(
                    "rel_trunc and soft_trunc are mutually exclusive "
                    "truncation modes"
                )
            if not 0.0 < self.rel_trunc < 1.0:
                raise ValueError(
                    f"rel_trunc must be in (0, 1), got {self.rel_trunc}"
                )
            if self.method != "eigh":
                raise ValueError(
                    "rel_trunc is a spectrum mask and requires "
                    f"method='eigh'; got method={self.method!r} (the "
                    "Newton–Schulz paths have no mask to apply — "
                    "ops/wct.py _sqrt_kernels)"
                )
        if self.ns_iters is not None and not isinstance(self.ns_iters, int):
            for pair in self.ns_iters:
                if (
                    not isinstance(pair, tuple) or len(pair) != 2
                    or pair[0] not in vgg.RELU_TARGETS
                    or not isinstance(pair[1], int)
                ):
                    raise ValueError(
                        "ns_iters must be None, an int, or a tuple of "
                        f"('reluN_1', iters) pairs; got {self.ns_iters!r}"
                    )
        if isinstance(self.ns_iters, int) and self.ns_iters < 1:
            raise ValueError(f"ns_iters must be >= 1, got {self.ns_iters}")
        if self.pack2_junction and (self.fuse_junction or self.fold_transform):
            raise ValueError(
                "pack2_junction is mutually exclusive with fuse_junction "
                "and fold_transform (all three rewrite the same decoder "
                "tail / encoder head segment)"
            )
        if self.pack2_tail_only and not self.pack2_junction:
            raise ValueError(
                "pack2_tail_only scopes pack2_junction and requires it "
                "to be enabled"
            )
        if self.pack2_junction_only and not self.pack2_junction:
            raise ValueError(
                "pack2_junction_only scopes pack2_junction and requires "
                "it to be enabled"
            )
        if self.compose_conv0 and self.fuse_junction:
            raise ValueError(
                "compose_conv0 is incompatible with fuse_junction (the "
                "Pallas encoder head hard-codes the separate conv0)"
            )
        if self.pack2_junction_only and self.pack2_tail_only:
            raise ValueError(
                "pack2_junction_only and pack2_tail_only are mutually "
                "exclusive scopes (each restricts pack2 to the OTHER "
                "segment)"
            )

    def ns_iters_for(self, level: str) -> int | None:
        """The content-side NS iteration override for one cascade level."""
        if self.ns_iters is None or isinstance(self.ns_iters, int):
            return self.ns_iters
        for target, iters in self.ns_iters:
            if target == level:
                return iters
        return None

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


@dataclasses.dataclass(frozen=True)
class LevelStyle:
    """Per-level cached style statistics, what the configuration needs:
    ``stats`` for the WCT (and the swap level's coloring), ``adain`` for
    ``transform='adain'``, ``fs_white`` (the whitened style map, NCHW
    ``[1, C, Hs, Ws]`` f32) for the swap5 level only."""

    stats: wct_ops.StyleStats | None = None
    adain: adain_ops.AdainStats | None = None
    fs_white: torch.Tensor | None = None


StyleCache = dict[str, LevelStyle]  # relu target → LevelStyle


def init_params(
    seed: int | torch.Generator = 0,
    targets: tuple[str, ...] = DEFAULT_TARGETS,
    device: str | torch.device = "cuda",
) -> dict:
    """Random full-model params: {'encoder': ..., 'decoders': {target: ...}}."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
    return {
        "encoder": vgg.init_encoder_params(gen, dev),
        "decoders": {t: dec_lib.init_decoder_params(gen, t, dev) for t in targets},
    }


def _as_images(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def precompute_style(
    encoder_params: dict, style_img, cfg: CascadeConfig
) -> StyleCache:
    """Encode a style image ``[H, W, 3]`` once; cache per-level statistics.

    One trunk sweep (``encode_multi``) feeds every cascade level. The
    image is cast to ``cfg.dtype``; the statistics are f32. The swap5
    level takes its whitening and coloring kernels from one
    decomposition (``wct_tpu/models/cascade.py:354-372``).
    """
    with span("wct.precompute_style"):
        return _precompute_style(encoder_params, style_img, cfg)


def _precompute_style(encoder_params: dict, style_img, cfg: CascadeConfig) -> StyleCache:
    set_numerics(cfg.dtype)
    x = _as_images(style_img, encoder_params["conv1_1"]["w"].device)
    feats = vgg.encode_multi_nchw(
        encoder_params, to_nchw(x[None]).to(cfg.dtype), cfg.relu_targets,
        compose_pre=cfg.compose_conv0, ring=cfg.ring_conv,
    )
    cache: StyleCache = {}
    for level in cfg.relu_targets:
        f = feats[level].flatten(2)
        if cfg.swap5 and level == "relu5_1":
            w_s, k_s, mu_s = wct_ops.whiten_color_kernels_cn(
                f, method=cfg.method, soft_trunc=cfg.soft_trunc, rel_trunc=cfg.rel_trunc,
            )
            cache[level] = LevelStyle(
                stats=wct_ops.StyleStats(kernel=k_s[0], mean=mu_s[0]),
                fs_white=swap_ops.whiten_cn(f, w_s, mu_s).reshape(feats[level].shape),
            )
        elif cfg.transform == "adain":
            cache[level] = LevelStyle(adain=adain_ops.adain_stats_cn(f))
        else:
            cache[level] = LevelStyle(stats=wct_ops.style_stats_cn(
                f, method=cfg.method, groups=cfg.wct_groups, soft_trunc=cfg.soft_trunc,
                rel_trunc=cfg.rel_trunc,
            ))
    return cache


@torch.no_grad()
def interpolate_style_caches(
    caches: list[StyleCache], weights, cfg: CascadeConfig
) -> StyleCache:
    """Blend K styles' caches with ``weights [K]``.

    The WCT's coloring and AdaIN are linear in their statistics, so
    blending the cached statistics blends the colored features. The
    swap level's whitened map is not blendable: it keeps the first
    style's (``wct_tpu/models/cascade.py:377-406``).
    """
    out: StyleCache = {}
    for level in cfg.relu_targets:
        entries = [c[level] for c in caches]
        stats = adain = None
        if entries[0].stats is not None:
            stats = wct_ops.interpolate_stats([e.stats for e in entries], weights)
        if entries[0].adain is not None:
            means = torch.stack([e.adain.mean for e in entries])
            stds = torch.stack([e.adain.std for e in entries])
            w = values_on(weights, means.device, means.dtype)
            adain = adain_ops.AdainStats(
                mean=torch.tensordot(w, means, 1), std=torch.tensordot(w, stds, 1)
            )
        out[level] = LevelStyle(stats=stats, adain=adain, fs_white=entries[0].fs_white)
    return out


def _transform_level(
    feats: torch.Tensor, level: str, style: LevelStyle, alpha, cfg: CascadeConfig
) -> torch.Tensor:
    """The configured transform at one level on a batch of NCHW features:
    at relu5_1 with ``swap5`` the style-swap, else AdaIN or the WCT."""
    b, c, h, w = feats.shape
    x = feats.reshape(b, c, h * w)
    if cfg.swap5 and level == "relu5_1":
        w_c, mu_c = wct_ops.whitening_kernel_cn(x, **wct_kw(cfg, level))
        return swap_level(feats, w_c, mu_c, style, alpha, cfg)
    if cfg.transform == "adain":
        out = adain_ops.adain_from_stats_cn(x, style.adain, alpha)
    else:
        out = wct_ops.wct_from_stats_cn(x, style.stats, alpha, **wct_kw(cfg, level))
    return out.reshape(b, c, h, w)


def wct_kw(cfg: CascadeConfig, level: str) -> dict:
    """The keyword arguments of the content whitening at ``level`` (the
    swap level whitens without groups)."""
    groups = 1 if (cfg.swap5 and level == "relu5_1") else cfg.wct_groups
    return dict(method=cfg.method, groups=groups, soft_trunc=cfg.soft_trunc,
                ns_iters=cfg.ns_iters_for(level), rel_trunc=cfg.rel_trunc)


def swap_level(
    feats: torch.Tensor, w_c: torch.Tensor, mu_c: torch.Tensor, style: LevelStyle,
    alpha, cfg: CascadeConfig,
) -> torch.Tensor:
    """The swap5 level on NCHW relu5_1 ``feats`` whitened by ``(w_c, mu_c)``:
    the style-swap, the style's coloring and the α-blend."""
    b, c, h, w = feats.shape
    x = feats.reshape(b, c, h * w)
    white = swap_ops.whiten_cn(x, w_c, mu_c).reshape(b, c, h, w)
    swapped = swap_ops.style_swap_nchw(
        white, style.fs_white, cfg.ss_alpha, cfg.ss_patch_size, cfg.ss_stride
    ).reshape(b, c, h * w)
    colored = style.stats.kernel.float().mT @ swapped + style.stats.mean.float()[:, None]
    alpha = scalar_on(alpha, x.device)
    return (alpha * colored + (1.0 - alpha) * x.float()).to(x.dtype).reshape(b, c, h, w)


def _level_affine(feats: torch.Tensor, level: str, style: LevelStyle, alpha, cfg: CascadeConfig):
    """The level's transform of NCHW ``feats`` as per-image affines: AdaIN's
    diagonal ``(scale [B, C], bias [B, C])`` or the WCT's ``(M [B, C, C],
    bias [B, C])``, for ``decoder.fold_affine_into_conv``."""
    x = feats.flatten(2)
    if cfg.transform == "adain":
        return adain_ops.adain_transform_cn(x, style.adain, alpha)
    return wct_ops.wct_transform_cn(x, style.stats, alpha, **wct_kw(cfg, level))


def padded_input(content, cfg: CascadeConfig, device: torch.device):
    """Images ``[B, H, W, 3]`` as the NCHW map the cascade runs on, in
    ``cfg.dtype`` on ``device``, padded up to multiples of the deepest
    level's pool factor: ``(x, H, W)``, with the size to crop back to."""
    content = _as_images(content, device)
    _, h, w, _ = content.shape
    mult = max(vgg.TARGET_SCALE[t] for t in cfg.relu_targets)
    pad_h = (-h) % mult
    pad_w = (-w) % mult
    x = to_nchw(content).to(cfg.dtype)
    if pad_h or pad_w:
        mode = "reflect" if (pad_h < h and pad_w < w) else "replicate"
        x = F.pad(x, (0, pad_w, 0, pad_h), mode=mode)
    return x, h, w


def stylize_fn(
    params: dict, content, style_cache: StyleCache, alpha, cfg: CascadeConfig
) -> torch.Tensor:
    """The full cascade on a batch ``[B, H, W, 3]`` → ``[B, H, W, 3]`` in [0, 1].

    Inputs whose H/W are not multiples of the deepest level's pool
    factor are reflect-padded up front (edge-padded when too small to
    reflect) and cropped back at the end, so the output has the
    input's size. Under ``compute_dtype='bfloat16'`` the image is cast
    to bf16 on entry and the clipped result back to f32.

    The call runs in the span ``wct.stylize`` and each level in
    ``wct.level.<relu>``, its stages in ``wct.encode``,
    ``wct.transform``, ``wct.decode`` and ``wct.junction``
    (``utils.profiling.span``; in the packed relu1_1 tail the transform's
    span lies inside the decode's).
    """
    with span("wct.stylize"):
        return _stylize(params, content, style_cache, alpha, cfg)


def _stylize(params: dict, content, style_cache: StyleCache, alpha, cfg: CascadeConfig):
    set_numerics(cfg.dtype)
    x, h, w = padded_input(content, cfg, params_device(params))
    # Fused-junction eligibility is a static rule on the (padded) shape;
    # ineligible shapes take the unfused path.
    junction_ok = cfg.fuse_junction and x.shape[2] % 16 == 0 and x.shape[3] % 16 == 0
    # pack2 (``wct_tpu/models/cascade.py:477-487``): even batches only.
    # pack2_tail_only keeps the head and junctions unpacked; the packed
    # relu1_1 tail needs ungrouped WCT and is off under pack2_junction_only.
    pack2_all = cfg.pack2_junction and x.shape[0] % 2 == 0
    pack2_ok = pack2_all and not cfg.pack2_tail_only
    pack_tail_ok = pack2_all and cfg.wct_groups == 1 and not cfg.pack2_junction_only
    single_conv_tail = len(dec_lib.decoder_layers("relu1_1")) == 1
    enc = params["encoder"]
    head_weights = tuple(
        enc[name][k] for name in ("conv0", "conv1_1", "conv1_2") for k in ("w", "b")
    )
    # What the running state is: 'img' RGB, 'pooled' the encoder state
    # right after pool1, 'e1' relu1_1 features out of a shallow packed
    # junction, 'e1p' the same kept packed for the packed tail. (The fused
    # junction's 2→1 boundary runs unfused, below, so it makes no 'e1'.)
    state_kind = "img"
    ring = cfg.ring_conv
    for _ in range(cfg.passes):
        for li, level in enumerate(cfg.relu_targets):
            with span(_LEVEL_SPANS[level]):
                style = style_cache[level]
                dec_p = params["decoders"][level]
                layers = dec_lib.decoder_layers(level)
                if (level == "relu1_1" and pack_tail_ok and state_kind in ("img", "e1p")
                        and single_conv_tail):
                    if state_kind == "img":
                        with span("wct.encode"):
                            x = pack2.head_pack2_shallow(x, *head_weights[:4], ring=ring,
                                                         compose_pre=cfg.compose_conv0)
                    conv = dec_p[layers[0][1]]
                    with span("wct.decode"):
                        x = pack2.tail_pack2(
                            x, style.stats, alpha, conv["w"], conv["b"], transform=cfg.transform,
                            adain_stats=style.adain, method=cfg.method, soft_trunc=cfg.soft_trunc,
                            ns_iters=cfg.ns_iters_for(level), rel_trunc=cfg.rel_trunc, ring=ring,
                        )
                        if cfg.clip_between_levels:
                            x = x.clamp(0.0, 1.0)
                    state_kind = "img"
                    continue
                if state_kind == "e1":  # the junction already produced relu1_1 features
                    feats = x
                else:
                    with span("wct.encode"):
                        if state_kind == "img":
                            if (junction_ok or pack2_ok) and level != "relu1_1":
                                if pack2_ok:
                                    p1 = pack2.head_pack2(x, *head_weights, ring=ring,
                                                          compose_pre=cfg.compose_conv0)
                                else:
                                    p1 = junction_ops.encoder_head_nchw(x, *head_weights)
                                feats = vgg.encode_from_pool1_nchw(enc, p1, level, ring)
                            else:
                                feats = vgg.encode_multi_nchw(
                                    enc, x, (level,), compose_pre=cfg.compose_conv0, ring=ring
                                )[level]
                        elif state_kind == "pooled":
                            feats = vgg.encode_from_pool1_nchw(enc, x, level, ring)
                        else:  # 'e1p'
                            feats = pack2.unpack(x)
                nxt = cfg.relu_targets[li + 1] if li + 1 < len(cfg.relu_targets) else None
                # As the reference, fold only at C ≤ 128 (relu2_1, relu1_1),
                # where the O(9·C³) weight fold is small against the map it
                # saves; the swap is not affine.
                if (
                    cfg.fold_transform and vgg.TARGET_CHANNELS[level] <= 128
                    and not (cfg.swap5 and level == "relu5_1")
                ):
                    with span("wct.transform"):
                        m, bias = _level_affine(feats, level, style, alpha, cfg)
                    with span("wct.decode"):
                        x = dec_lib.decode_folded_nchw(dec_p, feats, level, m, bias)
                        if cfg.clip_between_levels:
                            x = x.clamp(0.0, 1.0)
                    state_kind = "img"
                    continue
                if junction_ok and len(layers) == 1 and not (cfg.swap5 and level == "relu5_1"):
                    # Single-conv decoder (relu1_1): fold each image's WCT or
                    # AdaIN affine into the conv; the apply and the 64→3
                    # conv collapse into the per-image-weight tail kernel.
                    with span("wct.transform"):
                        m, bias = _level_affine(feats, level, style, alpha, cfg)
                    conv = dec_p[layers[0][1]]
                    with span("wct.decode"):
                        wf, bf = dec_lib.fold_affine_into_conv(m, bias, conv["w"], conv["b"])
                        x = junction_ops.decoder_tail_nchw(
                            feats, wf, bf, clip=cfg.clip_between_levels
                        )
                    state_kind = "img"
                    continue
                with span("wct.transform"):
                    transformed = _transform_level(feats, level, style, alpha, cfg)
                if pack2_ok and nxt is not None and dec_lib.has_standard_tail(level):
                    with span("wct.decode"):
                        d = dec_lib.decode_partial_nchw(dec_p, transformed, level, ring)
                    deep = nxt != "relu1_1"
                    # Keep relu1_1 packed where the packed tail takes it next.
                    keep_packed = not deep and pack_tail_ok and single_conv_tail
                    with span("wct.junction"):
                        x = pack2.junction_pack2(
                            d, *dec_lib.tail_weights(dec_p, level), *head_weights, deep=deep,
                            clip=cfg.clip_between_levels, unpack_out=not keep_packed, ring=ring,
                            compose_pre=cfg.compose_conv0,
                        )
                    state_kind = "pooled" if deep else ("e1p" if keep_packed else "e1")
                # The 2→1 boundary keeps the unfused decode + encode, as the
                # reference does (its shallow kernel variant does not
                # compile for the TPU), so both compute the same thing.
                elif (
                    junction_ok and nxt is not None and nxt != "relu1_1"
                    and dec_lib.has_standard_tail(level)
                ):
                    with span("wct.decode"):
                        d = dec_lib.decode_partial_nchw(dec_p, transformed, level, ring)
                    with span("wct.junction"):
                        x = junction_ops.junction_nchw(
                            d, *dec_lib.tail_weights(dec_p, level), *head_weights,
                            deep=True, clip=cfg.clip_between_levels,
                        )
                    state_kind = "pooled"
                else:
                    with span("wct.decode"):
                        x = dec_lib.decode_nchw(dec_p, transformed, level, ring)
                        if cfg.clip_between_levels:
                            x = x.clamp(0.0, 1.0)
                    state_kind = "img"
    # Reference clips once before save (stylize.py:~150).
    return to_nhwc(x.clamp(0.0, 1.0)[:, :, :h, :w]).float()


@torch.no_grad()
def stylize(
    params: dict, content, style_cache: StyleCache, alpha, cfg: CascadeConfig
) -> torch.Tensor:
    """Entry point: ``stylize_fn`` without autograd."""
    return stylize_fn(params, content, style_cache, alpha, cfg)


@torch.no_grad()
def stylize_interp(
    params: dict, content, caches: list[StyleCache], weights, alpha, cfg: CascadeConfig
) -> torch.Tensor:
    """Multi-style interpolation, then the cascade: ``stylize`` on the
    blend of ``caches`` by ``weights [K]``."""
    cache = interpolate_style_caches(caches, weights, cfg)
    return stylize_fn(params, content, cache, alpha, cfg)


def stylize_pair(
    params: dict, content, style, alpha=1.0, cfg: CascadeConfig = CascadeConfig()
) -> torch.Tensor:
    """Convenience: single content [H,W,3] × style [H',W',3] → [H,W,3]."""
    cache = precompute_style(params["encoder"], style, cfg)
    content = _as_images(content, params_device(params))
    return stylize(params, content[None], cache, alpha, cfg)[0]


def stylize_microbatched(
    params: dict,
    content,
    style_cache: StyleCache,
    alpha,
    cfg: CascadeConfig,
    microbatch: int = 8,
    stylize_fn=None,
) -> torch.Tensor:
    """Batch-size-independent serving: pad and chunk to a fixed batch.

    Every request runs through the same ``[microbatch, H, W, 3]``
    shape (partial chunks padded with repeats of their last frame), so
    cuDNN and cuBLAS pick the same algorithms, and with deterministic
    cuDNN (``utils.device.set_numerics``) an image's output is
    bitwise-independent of the batch it was submitted in. Batch entries
    are independent, so a slot never depends on its neighbours' data.

    ``stylize_fn`` swaps the per-chunk executor (default ``stylize``) and
    keeps the pad and chunk discipline: e.g. ``parallel.stylize_sharded``
    with its mesh bound by ``functools.partial``, for data-parallel
    serving, where ``microbatch`` should be a multiple of the mesh's
    size (``wct_tpu/models/cascade.py:762-815``).
    """
    if microbatch < 1:
        raise ValueError(f"microbatch must be ≥ 1, got {microbatch}")
    if stylize_fn is None:
        stylize_fn = stylize
    content = _as_images(content, params_device(params))
    b = content.shape[0]
    if b == 0:
        return content
    outs = []
    for i in range(0, b, microbatch):
        chunk = content[i : i + microbatch]
        pad = microbatch - chunk.shape[0]
        if pad:
            chunk = torch.cat([chunk, chunk[-1:].expand(pad, -1, -1, -1)])
        out = stylize_fn(params, chunk, style_cache, alpha, cfg)
        outs.append(out[: microbatch - pad])
    return torch.cat(outs)
