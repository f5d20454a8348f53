"""wct_tpu_torch — universal style transfer (WCT) in PyTorch and CUDA.

The port of ``wct_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
The module layout mirrors ``wct_tpu`` so each counterpart is easy to
find. Plain tensor code is PyTorch; each kernel the JAX package wrote
in Pallas becomes a kernel written by hand for Hopper, under
``csrc/``, built at first use (``ops/_build.py``). Entry points run on
CUDA unless the caller passes ``device="cpu"``.

It imports nothing of JAX or of ``wct_tpu``: the JAX package is the
reference the tests hold it against.
"""

__version__ = "0.1.0"
