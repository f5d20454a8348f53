"""The multi-level stylization cascade.

Counterpart of ``wct_tpu/models/cascade.py``: content flows relu5_1 →
… → relu1_1; each level encodes the running image, applies the WCT at
``alpha`` against the cached style statistics, and decodes. The style
is encoded once (``precompute_style``, one trunk sweep for all levels).

This slice ports the unfused, unpacked f32 WCT path
(``cascade.py:526-557``, ``645-647``, ``705-715``). Every
``CascadeConfig`` field and check is kept, so the same illegal
combinations raise the same ``ValueError``; options that are legal but
not ported yet raise ``NotImplementedError`` naming the ROADMAP.md item
that carries them.

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
from wct_tpu_torch.ops import wct as wct_ops
from wct_tpu_torch.ops.convs import to_nchw, to_nhwc
from wct_tpu_torch.utils.device import params_device, resolve_device, set_fp32_numerics

DEFAULT_TARGETS = ("relu5_1", "relu4_1", "relu3_1", "relu2_1", "relu1_1")


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
        unported = (
            (self.transform == "adain", "transform='adain'", wct_ops.ITEM_ADAIN_SWAP),
            (self.swap5, "swap5", wct_ops.ITEM_ADAIN_SWAP),
            (self.wct_groups > 1, "wct_groups > 1", wct_ops.ITEM_TRUNC),
            (self.soft_trunc, "soft_trunc", wct_ops.ITEM_TRUNC),
            (self.rel_trunc is not None, "rel_trunc", wct_ops.ITEM_TRUNC),
            (self.compute_dtype == "bfloat16", "compute_dtype='bfloat16'",
             wct_ops.ITEM_THROUGHPUT),
            (self.method == "newton_schulz_fast", "method='newton_schulz_fast'",
             wct_ops.ITEM_THROUGHPUT),
            (self.conv_precision == "high", "conv_precision='high'",
             wct_ops.ITEM_THROUGHPUT),
            (self.fuse_junction, "fuse_junction",
             wct_ops.ITEM_VARIANTS + " with queue 2 kernels 4-6"),
            (self.pack2_junction, "pack2_junction", wct_ops.ITEM_VARIANTS),
            (self.fold_transform, "fold_transform", wct_ops.ITEM_VARIANTS),
            (self.ring_conv, "ring_conv", wct_ops.ITEM_VARIANTS),
        )
        for on, what, item in unported:
            if on:
                raise wct_ops.not_ported(what, item)

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
    """Per-level cached style statistics (the WCT coloring stats)."""

    stats: wct_ops.StyleStats


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

    One trunk sweep (``encode_multi``) feeds every cascade level.
    """
    set_fp32_numerics()
    x = _as_images(style_img, encoder_params["conv1_1"]["w"].device)
    feats = vgg.encode_multi_nchw(
        encoder_params, to_nchw(x[None]).to(cfg.dtype), cfg.relu_targets,
        compose_pre=cfg.compose_conv0,
    )
    return {
        level: LevelStyle(
            stats=wct_ops.style_stats_cn(feats[level].flatten(2), method=cfg.method)
        )
        for level in cfg.relu_targets
    }


def _transform_level(
    feats: torch.Tensor, level: str, style: LevelStyle, alpha, cfg: CascadeConfig
) -> torch.Tensor:
    """The WCT at one level on a batch of NCHW features."""
    b, c, h, w = feats.shape
    out = wct_ops.wct_from_stats_cn(
        feats.reshape(b, c, h * w), style.stats, alpha, method=cfg.method,
        ns_iters=cfg.ns_iters_for(level),
    )
    return out.reshape(b, c, h, w)


def stylize_fn(
    params: dict, content, style_cache: StyleCache, alpha, cfg: CascadeConfig
) -> torch.Tensor:
    """The full cascade on a batch ``[B, H, W, 3]`` → ``[B, H, W, 3]`` in [0, 1].

    Inputs whose H/W are not multiples of the deepest level's pool
    factor are reflect-padded up front (edge-padded when too small to
    reflect) and cropped back at the end, so the output has the
    input's size.
    """
    set_fp32_numerics()
    content = _as_images(content, params_device(params))
    _, h, w, _ = content.shape
    mult = max(vgg.TARGET_SCALE[t] for t in cfg.relu_targets)
    pad_h = (-h) % mult
    pad_w = (-w) % mult
    x = to_nchw(content).to(cfg.dtype)
    if pad_h or pad_w:
        mode = "reflect" if (pad_h < h and pad_w < w) else "replicate"
        x = F.pad(x, (0, pad_w, 0, pad_h), mode=mode)
    for _ in range(cfg.passes):
        for level in cfg.relu_targets:
            feats = vgg.encode_multi_nchw(
                params["encoder"], x, (level,), compose_pre=cfg.compose_conv0
            )[level]
            transformed = _transform_level(feats, level, style_cache[level], alpha, cfg)
            x = dec_lib.decode_nchw(params["decoders"][level], transformed, level)
            if cfg.clip_between_levels:
                x = x.clamp(0.0, 1.0)
    # Reference clips once before save (stylize.py:~150).
    return to_nhwc(x.clamp(0.0, 1.0)[:, :, :h, :w])


@torch.no_grad()
def stylize(
    params: dict, content, style_cache: StyleCache, alpha, cfg: CascadeConfig
) -> torch.Tensor:
    """Entry point: ``stylize_fn`` without autograd."""
    return stylize_fn(params, content, style_cache, alpha, cfg)


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
) -> torch.Tensor:
    """Batch-size-independent serving: pad and chunk to a fixed batch.

    Every request runs through the same ``[microbatch, H, W, 3]``
    shape (partial chunks padded with repeats of their last frame), so
    cuDNN and cuBLAS pick the same algorithms, and with deterministic
    cuDNN (``utils.device.set_fp32_numerics``) an image's output is
    bitwise-independent of the batch it was submitted in. Batch entries
    are independent, so a slot never depends on its neighbours' data.
    """
    if microbatch < 1:
        raise ValueError(f"microbatch must be ≥ 1, got {microbatch}")
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
        out = stylize(params, chunk, style_cache, alpha, cfg)
        outs.append(out[: microbatch - pad])
    return torch.cat(outs)
