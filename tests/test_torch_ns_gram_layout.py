"""The operand layouts and tile plans of ``csrc/ns_sqrtm.cu`` and
``csrc/centered_gram.cu``, on the CPU.

Both kernels feed ``wgmma`` from shared memory through 128-byte-swizzle
descriptors (``csrc/conv_wgmma.cuh``): K-major rows of 128 bytes, eight rows
to a 1 KB atom, the address's 16-byte chunk bits [4, 7) XOR-ed with its row
bits [7, 10), one k-step's operand 32 bytes further along the rows. The
Newton–Schulz kernel's epilogue writes every product in that layout
(``pk``, hi and lo planes per 64 x 32 tile), and the Gram kernel reads
TMA boxes swizzled by 128 bytes (f32) or 64 bytes (bf16) and writes its
planes the same way. The functions below restate the kernels' index rules
(each names the line it restates); the tests read packed data only through
the descriptor's address rule, k-step by k-step, and hold what they read
to the matrices, and run the Gram kernel's tile plan (packing, masks,
splits, mirroring) in float64 against a plain centred Gram. The split of
N comes from the host (``ops/gram.py::split_columns``), which the kernel
takes as it is.
"""

import numpy as np
import pytest

from wct_tpu_torch.ops import gram

SBO, ROW = 1024, 128  # bytes between 8-row atoms; bytes per row


def _descriptor(start: int, row, k, esize: int = 4):
    """Byte address desc_sw128(start) reads for (row, k) of a k-step."""
    linear = start + (row // 8) * SBO + (row % 8) * ROW + k * esize
    return linear ^ (((linear >> 7) & 7) << 4)


def _in_tile(r, k):
    """csrc/ns_sqrtm.cu::pk's offset inside a tile, in floats."""
    return (r >> 3) * 256 + (r & 7) * 32 + ((((k >> 2) ^ (r & 7)) << 2) | (k & 3))


def _pk(i, j, cp):
    """csrc/ns_sqrtm.cu::pk: float offset of (i, j) in a packed form (hi
    plane; lo 2,048 floats on), 16 KB tiles (i / 64, j / 32) in row order."""
    return ((i >> 6) * (cp >> 5) + (j >> 5)) * 4096 + _in_tile(i & 63, j & 31)


def _pack(m: np.ndarray) -> np.ndarray:
    """A cp x cp f32 matrix as the epilogue writes it: hi = tf32(x) (round
    to nearest, ties away, on the bit pattern) and lo = tf32(x - hi)."""
    cp = m.shape[0]
    out = np.zeros(2 * cp * cp, dtype=np.float32)
    i, j = np.meshgrid(np.arange(cp), np.arange(cp), indexing="ij")
    bits = m.astype(np.float32).view(np.uint32)
    hi = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    lo_bits = (m.astype(np.float32) - hi).view(np.uint32)
    lo = ((lo_bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    at = _pk(i, j, cp)
    out[at] = hi
    out[at + 2048] = lo
    return out


def _read(packed: np.ndarray, rb: int, kb: int, j: int, cp: int, lo=False) -> np.ndarray:
    """The [64 rows, 8] operand of k-step j of tile (rb, kb), as a descriptor
    at the tile's start (+ 8 KB for lo) + 32 j reads it."""
    start = ((rb * (cp >> 5) + kb) * 4096) * 4 + (8192 if lo else 0) + 32 * j
    rows, ks = np.meshgrid(np.arange(64), np.arange(8), indexing="ij")
    return packed[_descriptor(start, rows, ks) // 4]


@pytest.mark.parametrize("cp", [128, 192, 512])
def test_packed_form_reads_back_through_the_descriptor(cp):
    """Every k-step of every tile reads back rows 64 rb .. and columns
    32 kb + 8 j .. of the matrix, hi and lo, and hi + lo is the value to
    22 bits."""
    rng = np.random.default_rng(cp)
    m = rng.standard_normal((cp, cp)).astype(np.float32)
    packed = _pack(m)
    for rb in range(cp // 64):
        for kb in range(cp // 32):
            for j in range(4):
                want = m[64 * rb:64 * rb + 64, 32 * kb + 8 * j:32 * kb + 8 * j + 8]
                got = _read(packed, rb, kb, j, cp) + _read(packed, rb, kb, j, cp, lo=True)
                np.testing.assert_allclose(got, want, rtol=2**-21, atol=0)


def test_product_from_packed_forms_is_x_times_w():
    """D = P . Q^T from two packed operands, tile by tile and k-step by
    k-step as a warpgroup's wgmma's read them, is X . W when P holds the
    rows of X and Q the rows of W^T: the forms the Newton–Schulz step reads
    (T from Z and Y^T, Y' from Y and T^T, Z' from T and Z^T)."""
    cp = 192
    rng = np.random.default_rng(1)
    x = rng.standard_normal((cp, cp)).astype(np.float32)
    w = rng.standard_normal((cp, cp)).astype(np.float32)
    p, q = _pack(x), _pack(np.ascontiguousarray(w.T))
    d = np.zeros((cp, cp))
    for rb in range(cp // 64):
        for cb in range(cp // 64):
            acc = np.zeros((64, 64))
            for kb in range(cp // 32):
                for j in range(4):
                    a = [_read(p, rb, kb, j, cp, lo).astype(np.float64) for lo in (False, True)]
                    b = [_read(q, cb, kb, j, cp, lo).astype(np.float64) for lo in (False, True)]
                    acc += a[1] @ b[0].T + a[0] @ b[1].T + a[0] @ b[0].T
            d[64 * rb:64 * rb + 64, 64 * cb:64 * cb + 64] = acc
    ref = x.astype(np.float64) @ w.astype(np.float64)
    assert np.abs(d - ref).max() <= 1e-5 * np.abs(ref).max()


def _tma_box_at(r, c, esize):
    """csrc/centered_gram.cu::raw_at: byte offset of 16-byte chunk c of row r
    of a 64 x 32 box, as the TMA copy writes it with its 128-byte (f32) or
    64-byte (bf16) swizzle."""
    if esize == 4:
        return r * 128 + ((c ^ (r & 7)) << 4)
    return r * 64 + ((c ^ ((r >> 1) & 3)) << 4)


@pytest.mark.parametrize("esize", [4, 2])
def test_tma_box_swizzle_and_conflict_free_reads(esize):
    """The swizzle raw_at undoes is the copy's own (chunk bits [4, 7) or
    [4, 6) XOR-ed with bits [7, 10) or [7, 9) of the linear offset), every
    chunk of the box lands once, and the eight threads of a quarter warp
    (rows 4 q .. 4 q + 3, halves 0 and 1) read eight distinct bank groups."""
    row_bytes, chunks = 32 * esize, 32 * esize // 16
    mask = 7 if esize == 4 else 3
    seen = set()
    for r in range(64):
        for c in range(chunks):
            linear = r * row_bytes + 16 * c
            assert _tma_box_at(r, c, esize) == linear ^ (((linear >> 7) & mask) << 4)
            seen.add(_tma_box_at(r, c, esize))
    assert len(seen) == 64 * chunks
    per_thread = chunks // 2  # a thread reads half a row: 16 columns
    for q in range(16):
        for k in range(per_thread):
            groups = {(_tma_box_at(4 * q + t // 2, per_thread * (t % 2) + k, esize) // 16) % 8
                      for t in range(8)}
            assert len(groups) == 8


@pytest.mark.parametrize("n", [1, 7, 1000, 1024, 4096, 65536, 65537, 262144, 921600, 2**29])
def test_split_columns_follow_n_alone(n):
    """Splits of a multiple of 1,024 columns, never more than MAX_SPLITS of
    them, and the smallest such split."""
    split = gram.split_columns(n)
    assert split % gram.SPLIT == 0 and split >= gram.SPLIT
    assert -(-n // split) <= gram.MAX_SPLITS
    assert split == gram.SPLIT or -(-n // (split - gram.SPLIT)) > gram.MAX_SPLITS


def _gram_plan(B, C):
    """csrc/centered_gram.cu::plan: (packed, tile pairs, image groups)."""
    if C <= 32:
        return 1, 1, -(-B // (64 // C))
    t = -(-C // 64)
    return 0, t * (t + 1) // 2, B


def _emulated_gram(x: np.ndarray, split: int) -> np.ndarray:
    """The Gram kernel's plan in float64: per job (image group, tile pair)
    and split, the rows the tile holds (gram_kernel's Rows), centred and
    masked per slice of 32 columns, the partials summed over splits in
    order, and the entries i <= j of each image's own block written to
    (i, j) and (j, i)."""
    B, C, N = x.shape
    packed, pairs, groups = _gram_plan(B, C)
    tiles = 1 if packed else -(-C // 64)
    mean = x.mean(-1)
    out = np.full((B, C, C), np.nan)
    pair_list = [(ti, tj) for ti in range(tiles) for tj in range(ti, tiles)]
    assert len(pair_list) == pairs

    def rows(tile, z):
        r = np.arange(64)
        if packed:
            img, ch = z * (64 // C) + r // C, r % C
            ok = (ch < C) & (img < B) & (r < 64 // C * C)
        else:
            img, ch = np.full(64, z), tile * 64 + r
            ok = ch < C
        return img, ch, ok

    S = -(-N // split)
    for z in range(groups):
        for ti, tj in pair_list:
            acc = np.zeros((64, 64))
            ia, ca, oka = rows(ti, z)
            ib, cb, okb = rows(tj, z)
            for s in range(S):
                n0, n1 = s * split, min(s * split + split, N)
                for k0 in range(n0, n1, 32):
                    cols = np.arange(k0, k0 + 32)
                    live = cols < n1

                    def tile(img, ch, ok):
                        t = np.zeros((64, 32))
                        sel = np.where(ok)[0]
                        t[sel] = x[img[sel], ch[sel]][:, np.minimum(cols, N - 1)]
                        t[sel] -= mean[img[sel], ch[sel]][:, None]
                        t[:, ~live] = 0
                        return t

                    acc += tile(ia, ca, oka) @ tile(ib, cb, okb).T
            for r in range(64):
                for c in range(64):
                    if not (oka[r] and okb[c]) or (packed and r // C != c // C):
                        continue
                    i, j = ca[r], cb[c]
                    if i > j:
                        continue
                    out[ia[r], i, j] = out[ia[r], j, i] = acc[r, c]
    return out


@pytest.mark.parametrize("b,c,n,split", [(3, 16, 100, 64), (5, 17, 70, 32), (2, 48, 131, 64),
                                         (2, 130, 96, 32), (9, 8, 40, 32)])
def test_gram_plan_covers_every_entry_once_and_right(b, c, n, split):
    """Every entry of every image's Gram is written (none left NaN), and the
    plan's sum is the centred Gram: packed tiles keep only each image's own
    block, partial tiles mask their rows, splits and slices mask columns."""
    rng = np.random.default_rng(b * c + n)
    x = np.maximum(rng.standard_normal((b, c, n)), 0)
    got = _emulated_gram(x, split)
    assert not np.isnan(got).any()
    cx = x - x.mean(-1, keepdims=True)
    np.testing.assert_allclose(got, cx @ cx.transpose(0, 2, 1), rtol=1e-12, atol=1e-12)
    assert np.array_equal(got, got.transpose(0, 2, 1))
