"""The port's training data pipeline against ``wct_tpu``'s, and the
gradients of its reflect pad.

The numpy generators must give the same bits as the JAX package's for
the same seed. The device pool sampler draws from a ``torch.Generator``
(jax.random's bits are not reproduced), so it is held to the same
contract as ``tests/test_trainer.py::test_device_pool_sampler``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wct_tpu.train import data as jdata
from wct_tpu.utils import images as jimages
from wct_tpu_torch.ops import convs
from wct_tpu_torch.train import data as tdata


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers, and torch's OpenMP threads spinning on a loaded
    machine made a 30-step test take 150 s instead of 1."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("size", [32, 48])
def test_synthetic_image_same_bits(size):
    for seed in range(3):
        a = jdata.synthetic_image(np.random.default_rng(seed), size)
        b = tdata.synthetic_image(np.random.default_rng(seed), size)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_synthetic_image_v2_same_bits_and_photos():
    photos_j, photos_t = jdata._load_photos(), tdata._load_photos()
    assert [str(p) for p in jdata.train_photo_paths()] == [
        str(p) for p in tdata.train_photo_paths()]
    assert all("grace_hopper" not in str(p) for p in tdata.train_photo_paths())
    assert len(photos_j) == len(photos_t)
    for a, b in zip(photos_j, photos_t):
        np.testing.assert_array_equal(a, b)
    rng_j, rng_t = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(6):  # several branch draws
        a = jdata.synthetic_image_v2(rng_j, 48, photos_j)
        b = tdata.synthetic_image_v2(rng_t, 48, photos_t)
        np.testing.assert_array_equal(a, b)
        assert b.min() >= 0.0 and b.max() <= 1.0


def test_rich_pool_and_synthetic_pool_same_bits():
    np.testing.assert_array_equal(jdata.rich_pool(4, 32, seed=5), tdata.rich_pool(4, 32, seed=5))
    np.testing.assert_array_equal(
        jdata.synthetic_pool(np.random.default_rng(1), 3, 32),
        tdata.synthetic_pool(np.random.default_rng(1), 3, 32))


@pytest.mark.parametrize("pool_size", [0, 6])
def test_synthetic_batches_same_bits(pool_size):
    it_j = jdata.synthetic_batches(2, 32, seed=4, pool_size=pool_size)
    it_t = tdata.synthetic_batches(2, 32, seed=4, pool_size=pool_size)
    for _ in range(3):
        a, b = next(it_j), next(it_t)
        assert a.dtype == b.dtype == (np.uint8 if pool_size else np.float32)
        np.testing.assert_array_equal(a, b)


def test_batch_generator_same_bits(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(7):
        p = tmp_path / f"img{i}.png"
        jimages.save_img(p, rng.random((40, 36 + i, 3)))
        paths.append(str(p))
    (tmp_path / "bad.png").write_bytes(b"not a png")
    paths.append(str(tmp_path / "bad.png"))  # skipped with a warning
    a = list(jdata.batch_generator(paths, 3, 32, seed=2, loop=False, decode_workers=2))
    b = list(tdata.batch_generator(paths, 3, 32, seed=2, loop=False, decode_workers=2))
    assert [x.shape for x in b] == [(3, 32, 32, 3), (3, 32, 32, 3), (1, 32, 32, 3)]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_device_pool_sampler_variants_and_determinism():
    pool_np = tdata.synthetic_pool(np.random.default_rng(0), 6, 16)
    pool = torch.from_numpy(pool_np)
    sample = tdata.make_pool_sampler(5)
    b1, b2, b3 = sample(pool, 7, 5), sample(pool, 7, 5), sample(pool, 7, 6)
    assert b1.dtype == torch.uint8 and tuple(b1.shape) == (5, 16, 16, 3)
    assert torch.equal(b1, b2)  # same (seed, step) → same batch
    assert not torch.equal(b1, b3)
    variants = [f(np.rot90(img, k)) for img in pool_np for k in range(4)
                for f in (lambda x: x, lambda x: x[:, ::-1])]
    for out in b1.numpy():
        assert any(np.array_equal(out, v) for v in variants)


def test_device_pool_sampler_reaches_all_eight_variants():
    """One asymmetric image: every (rot90 k, flip) comes out, each exactly
    as numpy makes it."""
    img = np.arange(4 * 4 * 3, dtype=np.uint8).reshape(1, 4, 4, 3)
    sample = tdata.make_pool_sampler(64)
    seen = set()
    for step in range(4):
        for out in sample(torch.from_numpy(img), 0, step).numpy():
            for k in range(4):
                for flip in (0, 1):
                    v = np.rot90(img[0], k)
                    if np.array_equal(out, v[:, ::-1] if flip else v):
                        seen.add((k, flip))
    assert seen == {(k, f) for k in range(4) for f in (0, 1)}


def test_device_pool_batches_resume_at_start_step():
    pool_np = tdata.synthetic_pool(np.random.default_rng(1), 5, 16)
    full = tdata.device_pool_batches(pool_np, 3, seed=2, device="cpu")
    ref = [next(full) for _ in range(5)]
    resumed = tdata.device_pool_batches(pool_np, 3, seed=2, start_step=3, device="cpu")
    assert torch.equal(next(resumed), ref[3]) and torch.equal(next(resumed), ref[4])


def test_device_pool_needs_square_images():
    sample = tdata.make_pool_sampler(2)
    with pytest.raises(ValueError, match="square"):
        sample(torch.zeros(3, 8, 6, 3, dtype=torch.uint8), 0, 0)


def test_prefetcher_delivers_tensors_in_order():
    n = 200

    def gen():
        for i in range(n):
            yield np.full((1, 2, 2, 1), i, np.float32)

    pf = tdata.DevicePrefetcher(gen(), depth=3, device="cpu")
    seen = [int(b[0, 0, 0, 0]) for b in pf]
    assert seen == list(range(n))


def test_prefetcher_exhaustion_latches():
    pf = tdata.DevicePrefetcher(iter([np.zeros((1, 2, 2, 1), np.float32)]), depth=2,
                                device="cpu")
    assert len(list(pf)) == 1
    with pytest.raises(StopIteration):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_error_latches():
    def bad_gen():
        yield np.zeros((1, 2, 2, 1), np.float32)
        raise RuntimeError("decode failed")

    pf = tdata.DevicePrefetcher(bad_gen(), depth=2, device="cpu")
    assert isinstance(next(pf), torch.Tensor)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="decode failed"):
            next(pf)


def test_prefetcher_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdata.DevicePrefetcher(iter([]), device="cuda")


@pytest.mark.parametrize("shape,pad", [((2, 3, 5, 7), 1), ((1, 2, 2, 2), 1), ((2, 4, 9, 6), 2)])
def test_reflect_pad_backward_matches_f_pad(shape, pad):
    """The fixed-order fold equals ``F.pad``'s backward (float64: to the
    last bits of a reordered sum); forward bits are F.pad's."""
    x = torch.randn(*shape, dtype=torch.float64, requires_grad=True)
    g = torch.randn(shape[0], shape[1], shape[2] + 2 * pad, shape[3] + 2 * pad,
                    dtype=torch.float64)
    y = convs.pad_reflect_nchw(x, pad)
    assert torch.equal(y, F.pad(x, (pad,) * 4, mode="reflect"))
    ours, = torch.autograd.grad(y, x, g)
    ref, = torch.autograd.grad(F.pad(x, (pad,) * 4, mode="reflect"), x, g)
    torch.testing.assert_close(ours, ref, rtol=1e-14, atol=1e-14)
    again, = torch.autograd.grad(convs.pad_reflect_nchw(x, pad), x, g)
    assert torch.equal(ours, again)


def test_conv_gradients_flow_through_the_port_conv():
    """``conv2d_reflect_nchw`` with gradients equals F.pad + F.conv2d's."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((2, 3, 6, 5)), requires_grad=True)
    w = torch.tensor(rng.standard_normal((4, 3, 3, 3)), requires_grad=True)
    b = torch.tensor(rng.standard_normal(4), requires_grad=True)
    g = torch.tensor(rng.standard_normal((2, 4, 6, 5)))
    ours = torch.autograd.grad(convs.conv2d_reflect_nchw(x, w, b), (x, w, b), g)
    ref = torch.autograd.grad(F.conv2d(F.pad(x, (1,) * 4, mode="reflect"), w, b), (x, w, b), g)
    for a, r in zip(ours, ref):
        torch.testing.assert_close(a, r, rtol=1e-12, atol=1e-12)
