"""Seeded input images, made on the card in a few large calls.

A content or style image is a sum of smooth random colour fields at
several scales (a sixteenth, a quarter and the whole of the image's
width between features) put through a sigmoid, so that it has large
regions, edges and fine texture, as photographs do, and its VGG
features have full-rank covariances at every level. Every image of a
pool is drawn independently, so no two images of a pool are alike and
an output handed back for the wrong image is plainly wrong.

The same seed gives the same bytes on the same card and PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# (grid cells across the shorter side, weight) of each octave.
_OCTAVES = ((4, 1.0), (16, 0.7), (64, 0.45), (256, 0.25))


def images(n: int, h: int, w: int, seed: int, device, chunk: int = 8) -> torch.Tensor:
    """``n`` seeded RGB images ``[n, h, w, 3]`` uint8 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    side = min(h, w)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        acc = torch.zeros((m, 3, h, w), dtype=torch.float32, device=device)
        for cells, weight in _OCTAVES:
            gh = max(2, round(cells * h / side))
            gw = max(2, round(cells * w / side))
            grid = torch.randn((m, 3, gh, gw), generator=gen, device=device)
            acc += weight * F.interpolate(grid, size=(h, w), mode="bicubic", align_corners=False)
        rgb = torch.sigmoid(1.6 * acc)
        out[i:i + m] = (rgb * 255.0).round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    return out
