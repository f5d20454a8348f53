"""Decoder training: Adam trainer, data pipeline, checkpoints, layerwise init."""

from wct_tpu_torch.train.checkpoint import (  # noqa: F401
    load_pytree,
    params_from_numpy,
    params_to_numpy,
    save_pytree,
)
from wct_tpu_torch.train.data import (  # noqa: F401
    DevicePrefetcher,
    batch_generator,
    synthetic_batches,
)
from wct_tpu_torch.train.trainer import (  # noqa: F401
    TrainConfig,
    TrainState,
    eval_step,
    init_train_state,
    make_optimizer,
    make_sharded_train_step,
    reconstruction_loss,
    total_variation,
    train_step,
)
