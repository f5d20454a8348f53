"""Model layer: VGG-19 encoder, per-level decoders, stylization cascade."""

from wct_tpu_torch.models import cascade, decoder, vgg  # noqa: F401
from wct_tpu_torch.models.cascade import (  # noqa: F401
    CascadeConfig,
    StyleCache,
    init_params,
    precompute_style,
    stylize,
    stylize_fn,
    stylize_microbatched,
    stylize_pair,
)
