"""Per-level decoder trainer: Adam, pixel + feature + TV losses.

Counterpart of ``wct_tpu/train/trainer.py``. The loss is a plain
function of the decoder's parameters: the frozen encoder (its tensors
never require gradients) encodes the batch, the decoder decodes it, and
the encoder encodes the result again; pixel L2 + feature L2 (+ total
variation). ``train_step`` is one forward, one backward, an optional
global-norm clip and one Adam update with inverse-time decay.

Where the JAX package compiles the step into one program that donates
the state, the port runs eagerly and updates ``TrainState`` in place.
Nothing in a step reads a value back to the host: the metrics and the
clip scale stay tensors on the device, the learning rate comes from the
host's step count, and Adam's step counters live on the host, as
``torch.optim.Adam`` keeps them. So the host can queue steps ahead of
the card; a caller reads the metrics when it needs them.

Train one level per call, as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from wct_tpu_torch.models import decoder, vgg
from wct_tpu_torch.ops.convs import to_nchw
from wct_tpu_torch.ops.wct import ITEM_MULTI_GPU, not_ported
from wct_tpu_torch.train import checkpoint as ckpt_lib
from wct_tpu_torch.utils.device import resolve_device, set_numerics


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Static trainer config (``wct_tpu/train/trainer.py:39-76``)."""

    relu_target: str = "relu4_1"
    batch_size: int = 8
    learning_rate: float = 1e-4
    lr_decay: float = 5e-5  # inverse-time decay rate
    pixel_weight: float = 1.0
    feature_weight: float = 1.0
    tv_weight: float = 0.0
    # Divide the feature L2 by the mean square of the target features
    # (not differentiated): a scale-free term for unnormalised encoders,
    # a near no-op for the normalised VGG. Off = the reference objective.
    feature_norm: bool = False
    # Global-norm gradient clip (0 = off), applied to the raw gradients
    # before Adam; stateless, so a resumed run keeps its Adam moments.
    grad_clip: float = 0.0
    crop_size: int = 256
    max_iter: int = 160_000
    save_iter: int = 5_000
    summary_iter: int = 100
    compute_dtype: str = "float32"
    # Recompute the encoder and decoder forwards in the backward pass:
    # less activation memory for more FLOPs.
    remat: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


def total_variation(x: torch.Tensor) -> torch.Tensor:
    """Anisotropic TV (L2) of images ``[B, H, W, C]``, mean per pixel."""
    dh = x[:, 1:, :, :] - x[:, :-1, :, :]
    dw = x[:, :, 1:, :] - x[:, :, :-1, :]
    return dh.float().pow(2).mean() + dw.float().pow(2).mean()


def _remat(fn):
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def reconstruction_loss(
    dec_params: dict, enc_params: dict, batch: torch.Tensor, cfg: TrainConfig
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Pixel + feature (+ TV) loss for one decoder.

    ``batch``: ``[B, H, W, 3]`` in [0, 1], or uint8, which is cast to the
    compute dtype and divided by 255 in that dtype on its device. The
    encoder runs twice (encode, re-encode) and only ``dec_params`` should
    require gradients. The three terms are f32 whatever the compute dtype.
    """
    target = cfg.relu_target
    x = batch.to(cfg.dtype)
    if batch.dtype == torch.uint8:
        x = x / 255.0
    x = to_nchw(x)

    def encode(p, img):
        return vgg.encode_multi_nchw(p, img, (target,))[target]

    def decode(p, f):
        return decoder.decode_nchw(p, f, target)

    if cfg.remat:
        encode, decode = _remat(encode), _remat(decode)
    code = encode(enc_params, x)
    decoded = decode(dec_params, code)

    pixel = (decoded.float() - x.float()).pow(2).mean()
    zero = torch.zeros((), device=x.device)
    if cfg.feature_weight:
        recode = encode(enc_params, decoded)
        feature = (recode.float() - code.float()).pow(2).mean()
        if cfg.feature_norm:
            power = code.float().pow(2).mean().detach()
            feature = feature / (power + 1e-8)
    else:
        # No re-encode at all: at relu5_1 that is a second 10-conv
        # forward and its backward.
        feature = zero
    tv = total_variation(decoded.permute(0, 2, 3, 1)) if cfg.tv_weight else zero
    total = cfg.pixel_weight * pixel + cfg.feature_weight * feature + cfg.tv_weight * tv
    return total, {"loss": total, "pixel": pixel, "feature": feature, "tv": tv}


def learning_rate(cfg: TrainConfig, count: int) -> float:
    """Inverse-time decay; ``count`` is the number of updates before this
    one, so the first update uses ``cfg.learning_rate``."""
    return cfg.learning_rate / (1.0 + cfg.lr_decay * count)


def make_optimizer(cfg: TrainConfig, params: dict) -> torch.optim.Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) over the leaves of ``params``;
    ``train_step`` sets its rate from ``learning_rate`` before each update."""
    return torch.optim.Adam(
        ckpt_lib.tree_leaves(params), lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8
    )


def clip_grads(grads: list[torch.Tensor], cfg: TrainConfig) -> list[torch.Tensor]:
    """Stateless global-norm clip, in place (no-op when ``cfg.grad_clip`` is
    0): ``g · min(1, clip / max(‖g‖₂, 1e-12))``, with the scale a tensor
    on the gradients' device."""
    if cfg.grad_clip < 0:
        raise ValueError(f"grad_clip must be >= 0, got {cfg.grad_clip}")
    if not cfg.grad_clip:
        return grads
    gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    torch._foreach_mul_(grads, scale)
    return grads


@dataclasses.dataclass
class TrainState:
    """Decoder parameters (OIHW, requiring gradients), their Adam and the
    number of steps taken. ``train_step`` updates all three in place."""

    params: dict
    optimizer: torch.optim.Adam
    step: int


def train_state_from_params(params: dict, cfg: TrainConfig, step: int = 0) -> TrainState:
    """A state with fresh Adam moments over ``params`` (the port's tensors)."""
    for p in ckpt_lib.tree_leaves(params):
        p.requires_grad_(True)
    set_numerics(cfg.dtype)
    return TrainState(params=params, optimizer=make_optimizer(cfg, params), step=step)


def init_train_state(
    generator: torch.Generator, cfg: TrainConfig, device: str | torch.device = "cuda"
) -> TrainState:
    """He-init decoder for ``cfg.relu_target`` on ``device``, step 0."""
    params = decoder.init_decoder_params(generator, cfg.relu_target, resolve_device(device))
    return train_state_from_params(params, cfg)


def state_tree(state: TrainState) -> dict:
    """The state in the JAX package's ``state_latest.npz`` layout."""
    return ckpt_lib.train_state_to_numpy(state.params, state.optimizer, state.step)


def restore_train_state(
    tree: dict, cfg: TrainConfig, device: str | torch.device = "cuda"
) -> TrainState:
    """A ``state_tree`` (or the JAX package's saved state) back on ``device``;
    Adam's moments are restored where the tree has them."""
    params = ckpt_lib.params_from_numpy(tree["params"], device)
    state = train_state_from_params(params, cfg, step=int(tree["step"]))
    if "opt_state" in tree:
        ckpt_lib.load_adam_state(state.optimizer, params, tree["opt_state"])
    return state


@torch.no_grad()
def eval_step(
    dec_params: dict, enc_params: dict, batch: torch.Tensor, cfg: TrainConfig
) -> dict[str, torch.Tensor]:
    """Validation metrics, without gradients."""
    _, metrics = reconstruction_loss(dec_params, enc_params, batch, cfg)
    return metrics


def train_step(
    state: TrainState, enc_params: dict, batch: torch.Tensor, cfg: TrainConfig
) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """One forward, backward, clip and Adam update; ``state`` is updated
    in place and returned. The metrics are detached tensors on the device."""
    opt = state.optimizer
    opt.zero_grad(set_to_none=True)
    loss, metrics = reconstruction_loss(state.params, enc_params, batch, cfg)
    loss.backward()
    clip_grads([p.grad for p in opt.param_groups[0]["params"]], cfg)
    for group in opt.param_groups:
        group["lr"] = learning_rate(cfg, state.step)
    opt.step()
    state.step += 1
    return state, {k: v.detach() for k, v in metrics.items()}


def make_sharded_train_step(*args: Any, **kw: Any):
    """Data-parallel training belongs to the multi-GPU item."""
    raise not_ported("make_sharded_train_step (data-parallel training)", ITEM_MULTI_GPU)
