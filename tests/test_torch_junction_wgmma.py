"""The weight layouts of the junction kernel (``csrc/junction.cu``), on the CPU.

The 64→64 convs' weights reach ``wgmma`` through a shared-memory
descriptor (``csrc/conv_wgmma.cuh``): K-major rows of 128 bytes, eight
rows to a 1 KB atom (the descriptor's stride SBO), the 128-byte swizzle
XOR-ing an address's 16-byte chunk bits [4, 7) with its row bits
[7, 10), and one k-step's operand starting 32 bytes further along the
rows. ``_wgmma_weights`` writes that layout on the host. These tests read
the packed buffer only through that address rule, chunk by chunk and
k-step by k-step as the kernel's descriptors do, and hold what they read
to the weights and to ``F.conv2d``. The bf16 form's 64→3 and 3→64
stages take ``mma.sync`` B fragments (``_rgb_frags_bf16``,
``_e1_frags_bf16``), held the same way.
"""

import gc

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wct_tpu_torch.ops import junction

SBO = 1024  # bytes between 8-row atoms
ROW = 128  # bytes per row (the swizzle width)
CHUNK = {torch.bfloat16: 8192, torch.float32: 16384}  # bytes per ring chunk
ESIZE = {torch.bfloat16: 2, torch.float32: 4}
KSTEP = {torch.bfloat16: 16, torch.float32: 8}  # input channels per wgmma k-step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _weights(seed=3, co=64, ci=64):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((co, ci, 3, 3)) / 24).astype(np.float32))


def _swizzled(start: int, n: int, k: int, esize: int) -> int:
    """Byte address of element (row n, column k) of a K-major operand whose
    descriptor starts at ``start`` (atoms 1 KB-aligned), after the swizzle."""
    linear = start + (n // 8) * SBO + (n % 8) * ROW + k * esize
    return linear ^ (((linear >> 7) & 7) << 4)


def _read_b(buf: np.ndarray, dtype, chunk: int, j: int, lo: bool = False) -> np.ndarray:
    """The [64 output channels, K] operand of k-step ``j`` of ring chunk
    ``chunk``, as the kernel's descriptor reads it from ``buf`` (the packed
    weights' bytes); f32: hi, or lo (the chunk's second 8 KB)."""
    es, kk = ESIZE[dtype], KSTEP[dtype]
    start = chunk * CHUNK[dtype] + (8192 if lo else 0) + 32 * j
    n = np.arange(64)[:, None]
    k = np.arange(kk)[None, :]
    addr = np.vectorize(_swizzled)(start, n, k, es)
    words = buf.view(np.uint16 if es == 2 else np.uint32)
    return words[addr // es]


def _as_float(words: np.ndarray, dtype) -> np.ndarray:
    if dtype == torch.bfloat16:
        return (words.astype(np.uint32) << 16).view(np.float32)
    return words.view(np.float32)


def _packed(w, dtype) -> np.ndarray:
    out = junction._wgmma_weights(w, dtype)
    assert out.is_contiguous() and out.numel() * ESIZE[dtype] == 9 * 64 * 64 * ESIZE[dtype] * (
        2 if dtype == torch.float32 else 1)
    words = out.reshape(-1).view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
    return words.numpy().view(np.uint8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_every_element_maps_back_through_the_descriptor(dtype):
    """Each byte of the buffer is read exactly once over the conv's chunks
    and k-steps, and each read gives w[co, ci, ky, kx] (f32: its tf32 hi
    and lo)."""
    w = _weights()
    buf = _packed(w, dtype)
    per_tap = 64 // (4 * KSTEP[dtype])  # chunks per tap
    seen = np.zeros(buf.size // ESIZE[dtype], dtype=np.int64)
    hi_w = junction._tf32(w)
    lo_w = junction._tf32(w - hi_w)
    for chunk in range(9 * per_tap):
        tap, part = divmod(chunk, per_tap)
        for j in range(4):
            ci = 64 // per_tap * part + KSTEP[dtype] * j + np.arange(KSTEP[dtype])
            for lo in ((False, True) if dtype == torch.float32 else (False,)):
                got = _as_float(_read_b(buf, dtype, chunk, j, lo), dtype)
                if dtype == torch.bfloat16:
                    want = w.to(torch.bfloat16).float()[:, ci, tap // 3, tap % 3]
                else:
                    want = (lo_w if lo else hi_w)[:, ci, tap // 3, tap % 3]
                np.testing.assert_array_equal(got, want.numpy())
                es = ESIZE[dtype]
                start = chunk * CHUNK[dtype] + (8192 if lo else 0) + 32 * j
                for n in range(64):
                    for k in range(KSTEP[dtype]):
                        seen[_swizzled(start, n, k, es) // es] += 1
    assert (seen == 1).all()


def test_f32_hi_lo_split():
    """hi = tf32(w) and hi + lo within 2⁻²¹ of w, as the 3×TF32 products need."""
    w = _weights(seed=5)
    buf = _packed(w, torch.float32)
    for chunk, j in ((0, 0), (7, 3), (17, 2)):
        hi = _as_float(_read_b(buf, torch.float32, chunk, j), torch.float32)
        lo = _as_float(_read_b(buf, torch.float32, chunk, j, lo=True), torch.float32)
        tap, part = divmod(chunk, 2)
        v = w[:, 32 * part + 8 * j: 32 * part + 8 * j + 8, tap // 3, tap % 3].numpy()
        assert np.array_equal(hi, junction._tf32(torch.from_numpy(v)).numpy())
        assert (np.abs(hi.astype(np.float64) + lo - v) <= 2.0**-21 * np.abs(v)).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_conv_through_the_descriptor_equals_conv2d(dtype):
    """A 64→64 reflect conv on a small map computed as the kernel does (M
    pixels × K channels per k-step, taps and chunks in the kernel's
    order), its weights read only through the descriptor rule, equals
    ``F.conv2d`` at f32 rounding (f32 products: hi·hi + hi·lo + lo·hi)."""
    w = _weights(seed=9)
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.random((1, 64, 6, 7)).astype(np.float32))
    buf = _packed(w, dtype)
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect")[0].double()  # [64, 8, 9]
    per_tap = 64 // (4 * KSTEP[dtype])
    out = torch.zeros(6 * 7, 64, dtype=torch.float64)
    wq = w.to(torch.bfloat16).float() if dtype == torch.bfloat16 else w
    for chunk in range(9 * per_tap):
        tap, part = divmod(chunk, per_tap)
        dy, dx = divmod(tap, 3)
        for j in range(4):
            ci = 64 // per_tap * part + KSTEP[dtype] * j + np.arange(KSTEP[dtype])
            a = xp[ci, dy: dy + 6, dx: dx + 7].reshape(len(ci), -1).T  # [M, K]
            b = torch.from_numpy(_as_float(_read_b(buf, dtype, chunk, j), dtype)).double()
            if dtype == torch.float32:
                lo = torch.from_numpy(_as_float(_read_b(buf, dtype, chunk, j, lo=True), dtype))
                b = b + lo.double()
            out += a @ b.T
    ref = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect").double(), wq.double())[0]
    got = out.T.reshape(64, 6, 7)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 2.0**-20 * scale
    assert float((got.float() - F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), wq)[0]).abs().max()) \
        <= 1e-5 * scale


def _mma_b(frags: torch.Tensor, lane: int) -> np.ndarray:
    """The (k, n) entries an ``mma.m16n8k16`` B fragment of ``lane`` holds:
    n = lane // 4, k = 2 (lane % 4) + {0, 1, 8, 9}."""
    return np.array([2 * (lane % 4) + d for d in (0, 1, 8, 9)]), lane // 4


def test_rgb_fragments_bf16():
    """``_rgb_frags_bf16``: k-step ``4·tap + q``, lane ``4g + t`` holds
    w[g, 16q + 2t + {0, 1, 8, 9}, tap] for g < 3, zero above; summed over
    the 36 k-steps as the kernel does, they give ``F.conv2d``'s 64→3 conv."""
    rng = np.random.default_rng(12)
    w = torch.from_numpy((rng.standard_normal((3, 64, 3, 3)) / 24).astype(np.float32))
    f = junction._rgb_frags_bf16(w)
    assert f.shape == (36, 32, 4) and f.dtype == torch.bfloat16 and f.numel() * 2 == 9216
    wq = w.to(torch.bfloat16).float()
    x = torch.from_numpy(rng.random((1, 64, 5, 4)).astype(np.float32)).to(torch.bfloat16).float()
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect")[0]
    out = torch.zeros(8, 5 * 4)
    for s in range(36):
        tap, q = divmod(s, 4)
        b = torch.zeros(16, 8)
        for lane in range(32):
            ks, n = _mma_b(f, lane)
            b[ks, n] = f[s, lane].float()
            if n < 3:
                want = wq[n, 16 * q + ks, tap // 3, tap % 3]
            else:
                want = torch.zeros(4)
            assert torch.equal(f[s, lane].float(), want)
        a = xp[16 * q: 16 * q + 16, tap // 3: tap // 3 + 5, tap % 3: tap % 3 + 4].reshape(16, -1)
        out += b.T @ a
    ref = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), wq)[0].reshape(3, -1)
    assert float((out[:3] - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert float(out[3:].abs().max()) == 0.0


def test_e1_fragments_bf16():
    """``_e1_frags_bf16``: K = 9·ci + tap, padded from 27 to 32; lane
    ``4g + t`` of n-tile nt at k-step s holds w'[8nt + g, 16s + 2t +
    {0, 1, 8, 9}] (zero past 27), and the im2col product is ``F.conv2d``."""
    rng = np.random.default_rng(13)
    w = torch.from_numpy((rng.standard_normal((64, 3, 3, 3)) * 20).astype(np.float32))
    f = junction._e1_frags_bf16(w)
    assert f.shape == (2, 8, 32, 4) and f.numel() * 2 == 4096
    wq = w.to(torch.bfloat16).float()
    b = torch.zeros(32, 64)
    for s in range(2):
        for nt in range(8):
            for lane in range(32):
                ks, n = _mma_b(f, lane)
                k = 16 * s + ks
                b[k, 8 * nt + n] = f[s, nt, lane].float()
                want = torch.tensor([float(wq.reshape(64, 27)[8 * nt + n, kk]) if kk < 27 else 0.0
                                     for kk in k])
                assert torch.equal(f[s, nt, lane].float(), want)
    x = torch.from_numpy(rng.random((1, 3, 6, 5)).astype(np.float32)).to(torch.bfloat16).float()
    cols = F.unfold(F.pad(x, (1, 1, 1, 1), mode="reflect"), 3)[0]  # [27, P], k = 9 ci + tap
    got = (F.pad(cols.T, (0, 5)) @ b).T.reshape(64, 6, 5)
    ref = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), wq)[0]
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_packed_weights_follow_their_tensors():
    """The junction wrapper packs a set of weights once and packs again
    after an in-place update (a new version) or for other tensors."""
    w = _weights(seed=21)
    calls = []

    def pack():
        calls.append(1)
        return junction._wgmma_weights(w, torch.bfloat16)

    first = junction._packed("junction", torch.bfloat16, (w,), pack)
    assert junction._packed("junction", torch.bfloat16, (w,), pack) is first and len(calls) == 1
    w.add_(1.0)
    again = junction._packed("junction", torch.bfloat16, (w,), pack)
    assert len(calls) == 2 and not torch.equal(again, first)
    junction._packed("junction", torch.float32, (w,), pack)
    junction._packed("junction", torch.bfloat16, (w.clone(),), pack)
    assert len(calls) == 4


def test_packed_weights_go_with_their_tensors():
    """The packed weights are held by weak reference to their source
    tensors: once a source tensor is gone, so is its entry."""
    w, b = _weights(seed=23), torch.zeros(64)

    def pack():
        return junction._wgmma_weights(w, torch.float32), b.clone()

    before = len(junction._PACKED)
    junction._packed("junction", torch.float32, (w, b), pack)
    assert len(junction._PACKED) == before + 1
    del w
    gc.collect()
    assert len(junction._PACKED) == before


def test_junction_folds_conv0_once_per_parameter_set():
    """``junction_nchw`` on the same parameters twice hands the kernel the
    same folded conv1_1, so its packed weights are found again; the plain
    route's result is the same bits either way."""
    rng = np.random.default_rng(22)

    def t(*shape, scale=0.1):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    params = (t(64, 64, 3, 3), t(64), t(3, 64, 3, 3), t(3), t(3, 3, 1, 1), t(3), t(64, 3, 3, 3),
              t(64), t(64, 64, 3, 3), t(64))
    d = torch.from_numpy(rng.random((1, 64, 8, 8)).astype(np.float32))
    seen = []
    real = junction._route

    def route(name, x, kernel, plain, *args):
        seen.append(args[4])  # we1, as the kernel would get it
        return real(name, x, kernel, plain, *args)

    junction._route = route
    try:
        a = junction.junction_nchw(d, *params)
        b = junction.junction_nchw(d, *params)
    finally:
        junction._route = real
    assert seen[0] is seen[1] and torch.equal(a, b)
