"""Published peaks of the cards the benchmark runs on.

NVIDIA's data sheets, dense rates without sparsity, at the full power
limit (700 W for the SXM part). A run prints the card's power limit
beside its numbers: a card set below it runs slower under load.
"""

from __future__ import annotations

# name fragment -> rates in FLOP/s and bytes/s
_CARDS = {
    "H100 PCIe": {"bf16": 756.0e12, "tf32": 378.0e12, "fp32": 51.2e12, "hbm": 2.0e12},
    "H100": {"bf16": 989.0e12, "tf32": 494.7e12, "fp32": 67.0e12, "hbm": 3.35e12},
}


def card_peaks(device_name: str) -> dict:
    """The peaks of the card called ``device_name`` (``torch.cuda.
    get_device_name``); raises for a card the table does not hold."""
    for fragment, rates in _CARDS.items():
        if fragment in device_name:
            return dict(rates)
    raise KeyError(f"no published peaks for {device_name!r}")


def arithmetic_peak(device_name: str, precision: str) -> float:
    """The rate of a configuration's arithmetic: bf16 on the tensor
    cores, or for f32-class results three TF32 passes (the split that
    keeps f32 accuracy on the tensor cores), 494.7 / 3 TFLOP/s on the
    SXM part. The FFMA rate outside the tensor cores (``fp32``) is lower
    still; a route moved onto split TF32 could read above it."""
    rates = card_peaks(device_name)
    if precision == "bfloat16":
        return rates["bf16"]
    if precision == "float32":
        return rates["tf32"] / 3.0
    raise ValueError(f"no arithmetic peak for precision {precision!r}")
