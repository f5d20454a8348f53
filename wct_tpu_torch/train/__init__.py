"""Checkpoint I/O and the weight bridge from the JAX package's layout."""

from wct_tpu_torch.train.checkpoint import (  # noqa: F401
    load_pytree,
    params_from_numpy,
    params_to_numpy,
    save_pytree,
)
