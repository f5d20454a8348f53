"""The port's training route on the card: gradients of its convs and pads,
the prefetcher's copies and the pool sampler on CUDA tensors.

Every test here needs an NVIDIA GPU and skips without one; run them on
the card's machine with

    python -m pytest --noconftest -q -m cuda tests/test_torch_train_cuda.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wct_tpu_torch.ops import convs
from wct_tpu_torch.train import data as tdata

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from wct_tpu_torch.utils.device import set_fp32_numerics

    set_fp32_numerics()
    return torch.device("cuda")


@pytest.mark.parametrize("shape,out_c", [((2, 64, 34, 30), 64), ((4, 256, 128, 128), 128),
                                         ((8, 512, 16, 16), 512), ((2, 64, 64, 64), 3)])
def test_conv_gradients_against_float64(card, shape, out_c):
    """Within 1e-5 relative of float64 for x, w and b, the choice recorded
    in the training table, and the same bits twice. ((4, 256, 128²) → 128
    is a shape where cuDNN's heuristics pick an FFT path.)"""
    rng = np.random.default_rng(0)
    x64 = torch.tensor(rng.standard_normal(shape), device=card)
    w64 = torch.tensor(rng.standard_normal((out_c, shape[1], 3, 3)) / (3 * shape[1] ** 0.5),
                       device=card)
    b64 = torch.tensor(rng.standard_normal(out_c), device=card)
    g64 = torch.tensor(rng.standard_normal((shape[0], out_c, shape[2], shape[3])), device=card)
    ref = torch.autograd.grad(F.conv2d(F.pad(x64.requires_grad_(), (1,) * 4, mode="reflect"),
                                       w64.requires_grad_(), b64.requires_grad_()),
                              (x64, w64, b64), g64)
    runs = []
    for _ in range(2):
        x, w, b = (t.detach().float().requires_grad_() for t in (x64, w64, b64))
        runs.append(torch.autograd.grad(convs.conv2d_reflect_nchw(x, w, b), (x, w, b),
                                        g64.float()))
    torch.cuda.synchronize()
    for got, want in zip(runs[0], ref):
        assert float((got.double() - want).norm() / want.norm()) <= 1e-5
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    key = ((shape[0], shape[1], shape[2] + 2, shape[3] + 2), (out_c, shape[1], 3, 3),
           torch.float32, x64.device)
    assert key in convs.CONV_TIMES
    assert all(isinstance(convs.CONV_TIMES[key][f"cudnn_{d}"], bool) for d in ("fwd", "bwd"))


def test_reflect_pad_backward_is_deterministic_on_the_card(card):
    x = torch.randn(8, 64, 64, 64, device=card, requires_grad=True)
    g = torch.randn(8, 64, 66, 66, device=card)
    a, = torch.autograd.grad(convs.pad_reflect_nchw(x), x, g)
    b, = torch.autograd.grad(convs.pad_reflect_nchw(x), x, g)
    ref, = torch.autograd.grad(F.pad(x, (1,) * 4, mode="reflect"), x, g)
    assert torch.equal(a, b)
    torch.testing.assert_close(a, ref, rtol=1e-6, atol=1e-6)


def test_prefetcher_copies_every_batch_in_order(card):
    n = 64
    batches = [np.full((2, 32, 32, 3), i, np.uint8) for i in range(n)]
    pf = tdata.DevicePrefetcher(iter(batches), depth=2, device=card)
    seen = []
    for b in pf:
        assert b.device.type == "cuda" and b.dtype == torch.uint8
        seen.append(b.float().mean())  # used on the consumer's stream
    assert [int(v) for v in torch.stack(seen).tolist()] == list(range(n))


def test_pool_sampler_on_the_card_gives_pool_variants(card):
    pool_np = tdata.synthetic_pool(np.random.default_rng(0), 6, 16)
    sample = tdata.make_pool_sampler(8)
    pool = torch.from_numpy(pool_np).to(card)
    b1, b2 = sample(pool, 3, 4), sample(pool, 3, 4)
    assert torch.equal(b1, b2)
    variants = [f(np.rot90(img, k)) for img in pool_np for k in range(4)
                for f in (lambda x: x, lambda x: x[:, ::-1])]
    for out in b1.cpu().numpy():
        assert any(np.array_equal(out, v) for v in variants)


def test_step_directory_checkpoint_resumes_bitwise_on_the_card(card, tmp_path):
    """Four relu1_1 steps from the bundle's encoder, saved each step by the
    step-directory backend with ``keep=2``: two directories remain, the
    highest restores the state bitwise, and two more steps from it give
    the bits two more steps from the npz backend's restore give."""
    from pathlib import Path

    import numpy as np

    from wct_tpu_torch.train import checkpoint as tck
    from wct_tpu_torch.train import trainer as tt

    bundle = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
    enc = tck.params_from_numpy(tck.load_pytree(bundle)["encoder"], card)
    cfg = tt.TrainConfig(relu_target="relu1_1", batch_size=2, crop_size=64)
    batch = torch.from_numpy(np.stack([tdata.synthetic_image(np.random.default_rng(i), 64)
                                       for i in range(2)])).to(card)
    state = tt.init_train_state(torch.Generator().manual_seed(0), cfg, card)
    steps = tck.TrainCheckpointer(tmp_path / "s", fmt="orbax", keep=2)
    npz = tck.TrainCheckpointer(tmp_path / "n")
    for _ in range(4):
        state, _ = tt.train_step(state, enc, batch, cfg)
        steps.save(state.step, tt.state_tree(state))
        npz.save(state.step, tt.state_tree(state))
    assert steps.steps() == [3, 4]
    a = tt.restore_train_state(steps.restore_latest(), cfg, card)
    b = tt.restore_train_state(npz.restore_latest(), cfg, card)
    for _ in range(2):
        a, _ = tt.train_step(a, enc, batch, cfg)
        b, _ = tt.train_step(b, enc, batch, cfg)
    fa, fb = tck._flatten(tt.state_tree(a)), tck._flatten(tt.state_tree(b))
    assert fa.keys() == fb.keys() and all(np.array_equal(fa[k], fb[k]) for k in fa)
