"""The port's colour and image helpers against ``wct_tpu.utils``.

Both are numpy, so the port's copies are held bitwise to the
reference's on the same inputs.
"""

import numpy as np
import pytest
import torch

from wct_tpu.utils import colors as jcolors
from wct_tpu.utils import images as jimages
from wct_tpu_torch.utils import colors as tcolors
from wct_tpu_torch.utils import images as timages


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers, and torch's OpenMP threads spinning on a loaded
    machine made a 30-step test take 150 s instead of 1."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_ycc_matches_reference_and_round_trips():
    rgb = np.random.default_rng(0).random((8, 9, 3))
    np.testing.assert_array_equal(tcolors.rgb_to_ycc(rgb), jcolors.rgb_to_ycc(rgb))
    np.testing.assert_array_equal(tcolors.ycc_to_rgb(rgb), jcolors.ycc_to_rgb(rgb))
    np.testing.assert_allclose(tcolors.ycc_to_rgb(tcolors.rgb_to_ycc(rgb)), rgb, atol=1e-10)


def test_preserve_colors_matches_reference():
    rng = np.random.default_rng(1)
    content = rng.random((16, 12, 3)).astype(np.float32)
    stylized = rng.random((16, 12, 3)).astype(np.float32)
    got = tcolors.preserve_colors_np(content, stylized)
    np.testing.assert_array_equal(got, jcolors.preserve_colors_np(content, stylized))
    assert got.dtype == np.float32
    np.testing.assert_allclose(tcolors.preserve_colors_np(content, content), content, atol=1e-5)
    with pytest.raises(ValueError, match="shape mismatch"):
        tcolors.preserve_colors_np(content, stylized[:8])


def test_coral_matches_reference_and_target_stats():
    rng = np.random.default_rng(2)
    src = (rng.random((32, 32, 3)) * 0.5).astype(np.float32)
    tgt = (rng.random((24, 40, 3)) * 0.5 + 0.4).astype(np.float32)
    got = tcolors.coral_numpy(src, tgt)
    np.testing.assert_array_equal(got, jcolors.coral_numpy(src, tgt))
    assert got.shape == src.shape and got.dtype == np.float32
    out, t = got.reshape(-1, 3).astype(np.float64), tgt.reshape(-1, 3).astype(np.float64)
    np.testing.assert_allclose(out.mean(0), t.mean(0), atol=2e-2)
    np.testing.assert_allclose(np.cov(out, rowvar=False), np.cov(t, rowvar=False), atol=2e-2)


def test_resize_exact_and_random_crop_match_reference():
    rng = np.random.default_rng(3)
    img = rng.random((30, 50, 3)).astype(np.float32)
    np.testing.assert_array_equal(timages.resize_exact(img, 17, 23),
                                  jimages.resize_exact(img, 17, 23))
    assert timages.resize_exact(img, 17, 23).shape == (17, 23, 3)
    for size in (20, 40):  # 40 > 30: resized up first
        got = timages.random_crop(img, size, np.random.default_rng(7))
        ref = jimages.random_crop(img, size, np.random.default_rng(7))
        np.testing.assert_array_equal(got, ref)
        assert got.shape == (size, size, 3)


def test_get_img_random_crop_matches_reference(tmp_path):
    img = np.random.default_rng(4).random((40, 64, 3))
    timages.save_img(tmp_path / "a.png", img)
    got = timages.get_img_random_crop(tmp_path / "a.png", 32, np.random.default_rng(5))
    ref = jimages.get_img_random_crop(tmp_path / "a.png", 32, np.random.default_rng(5))
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (32, 32, 3)
    assert timages.get_img_random_crop(tmp_path / "a.png", 16).shape == (16, 16, 3)
