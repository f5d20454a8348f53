"""What the host side and the index plans of the encoder head and the
decoder tail kernels compute, replayed on the CPU.

``csrc/encoder_head.cu`` walks tiles of 32 rows × 16 columns with
persistent blocks, takes conv1_2's weights from a ring of bulk-copied
chunks that runs on across a block's tiles (f32, 3 slots) or holds the
whole conv (bf16, 9 slots),
and reads them through ``wgmma``'s 128-byte-swizzle descriptor.
``csrc/decoder_tail.cu`` stages 64 × 64 tiles with a one-pixel halo as
TMA boxes (rows -1 and H patched with their reflections), takes the left
and right neighbours of a thread's four columns from the next lanes or,
at the image's edge, from its own columns, and lays each image's OIHW
weights out in shared memory as it loads them. These tests
replay those index rules in numpy, with the constants the sources use,
and hold what they read to the weights and to the reflect-padded conv
the plain versions compute: every output written once, every input the
reflected pixel.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wct_tpu_torch.ops import junction

SBO, ROW = 1024, 128  # the descriptor's atom stride and row bytes (csrc/conv_wgmma.cuh)
CHUNKS = {torch.float32: 18, torch.bfloat16: 9}  # Tc<T>::kChunks
CHUNK_BYTES = {torch.float32: 16384, torch.bfloat16: 8192}  # Tc<T>::kChunkBytes
KSTEP = {torch.float32: 8, torch.bfloat16: 16}
ESIZE = {torch.float32: 4, torch.bfloat16: 2}
TILE = 16
ROWS = 32  # Head<T>::kRows
SLOTS = {torch.float32: 3, torch.bfloat16: 9}  # Head<T>::kS
TAIL = 64  # decoder_tail.cu: kTailW = kTailH
LEAD = {torch.float32: 4, torch.bfloat16: 8}  # Tail<T>::kLead: 16 bytes of columns before the tile


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _reflect(g, n):
    g = np.asarray(g)
    return np.where(g < 0, -g, np.where(g >= n, 2 * (n - 1) - g, g))


def _swizzled(start, n, k, esize):
    linear = start + (n // 8) * SBO + (n % 8) * ROW + k * esize
    return linear ^ (((linear >> 7) & 7) << 4)


def _head_weight_bytes(dtype, seed=3):
    rng = np.random.default_rng(seed)
    w12 = torch.from_numpy((rng.standard_normal((64, 64, 3, 3)) / 24).astype(np.float32))
    we1 = torch.from_numpy((rng.standard_normal((64, 3, 3, 3)) * 20).astype(np.float32))
    t1, c1, t2, c2 = junction._head_weights(we1, torch.zeros(64), w12, torch.ones(64), dtype)
    words = t2.reshape(-1).view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
    return w12, we1, t1, words.numpy().view(np.uint8)


def _read_chunk(slot_bytes, dtype, j, lo=False):
    """The [64, K] operand of k-step j of the chunk in ``slot_bytes``, as the
    descriptor reads it (f32: hi, or lo 8 KB on)."""
    es, kk = ESIZE[dtype], KSTEP[dtype]
    n = np.arange(64)[:, None]
    k = np.arange(kk)[None, :]
    addr = _swizzled((8192 if lo else 0) + 32 * j, n, k, es)
    words = slot_bytes.view(np.uint16 if es == 2 else np.uint32)
    w = words[addr // es]
    if dtype == torch.bfloat16:
        return (w.astype(np.uint32) << 16).view(np.float32)
    return w.view(np.float32)


@pytest.mark.parametrize("tiles", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_head_ring_delivers_each_chunk_through_the_descriptor(dtype, tiles):
    """A block's ring, replayed over its ``tiles`` tiles: thread 0 fills the
    first ``slots`` positions, each position's second warpgroup out refills
    its slot with the position ``slots`` on while the block has tiles left
    (never in bf16, whose ring holds the whole conv), and every wait reads
    the phase its position's use of the slot completes. Each chunk a tile's
    conv1_2 waits for holds, read through the descriptor, conv1_2's weights
    of its tap and channels (f32: tf32 hi and lo), and no slot is refilled
    before both warpgroups are done with it."""
    chunks, slots = CHUNKS[dtype], SLOTS[dtype]
    resident = slots == chunks
    assert resident == (dtype == torch.bfloat16)
    w12, _, _, packed = _head_weight_bytes(dtype)
    nbytes = CHUNK_BYTES[dtype]
    ring = [None] * slots  # (position, bytes) in each slot
    completed = [0] * slots  # phases completed per slot
    done = [0] * slots
    positions = tiles * chunks

    def refill(p):
        if p < positions:
            s = p % slots
            assert ring[s] is None or done[s] % 2 == 0, "a slot refilled while in use"
            src = (p % chunks) * nbytes
            ring[s] = (p, packed[src: src + nbytes])
            completed[s] += 1

    for q in range(slots):
        refill(q)
    per_tap = chunks // 9
    hi_w = junction._tf32(w12)
    for it in range(tiles):
        for c in range(chunks):
            q = c if resident else it * chunks + c
            s = q % slots
            assert completed[s] == q // slots + 1, "the wait's parity does not match the phase"
            pos, data = ring[s]
            assert pos == q and pos % chunks == c
            tap, part = divmod(c, per_tap)
            for j in range(4):
                ci = 64 // per_tap * part + KSTEP[dtype] * j + np.arange(KSTEP[dtype])
                got = _read_chunk(data, dtype, j)
                if dtype == torch.bfloat16:
                    want = w12.to(torch.bfloat16).float()[:, ci, tap // 3, tap % 3]
                else:
                    want = hi_w[:, ci, tap // 3, tap % 3]
                    lo = _read_chunk(data, dtype, j, lo=True)
                    np.testing.assert_array_equal(
                        lo, junction._tf32(w12 - hi_w)[:, ci, tap // 3, tap % 3].numpy())
                np.testing.assert_array_equal(got, want.numpy())
            if not resident:
                for _ in range(2):  # both warpgroups count themselves out
                    done[s] += 1
                    if done[s] % 2 == 0:
                        refill(q + slots)
    assert all(r is not None for r in ring)


def _head_plan(b, h, w, grid, rows=ROWS):
    """Every (image, pooled row, pooled column, channel group) the persistent
    blocks store, and every e1 row a stored output reads, per the kernel's
    walk: tile t = block + i · grid, tiles_x = W / 16 fastest."""
    tiles_x, tiles_y = w // TILE, -(-h // rows)
    n_tiles = b * tiles_x * tiles_y
    kRB = rows // 8
    written = np.zeros((b, h // 2, w // 2), dtype=np.int64)
    e1_reads = set()  # they depend on the tile's first row alone
    for blk in range(min(grid, n_tiles)):
        for t in range(blk, n_tiles, grid):
            img, r = divmod(t, tiles_x * tiles_y)
            y0, x0 = (r // tiles_x) * rows, (r % tiles_x) * TILE
            for warp in range(8):
                for p in range(kRB // 2):
                    oy = y0 // 2 + (kRB // 2) * warp + p
                    if oy >= h // 2:
                        continue
                    for g in range(0, 8, 2):
                        for e in (0, 2):
                            written[img, oy, x0 // 2 + g // 2 + 2 * e] += 1
                    for rb in (2 * p, 2 * p + 1):
                        y = y0 + kRB * warp + rb  # the slice's tile row
                        for dy in range(3):
                            e1_reads.add((y0, y, kRB * warp + rb + dy))
    return written, e1_reads


def _fixed_e1_rows(y0, h, rows=ROWS):
    """Image row each e1 region row holds after the halo fix (region row i is
    image row y0 - 1 + i; outside the image it takes its reflection where that
    lies in the region, conv_tiles.cuh; -1 where it is left alone)."""
    oy = y0 - 1
    out = []
    for i in range(rows + 2):
        gy = oy + i
        if 0 <= gy < h:
            out.append(gy)
        else:
            src = int(_reflect(gy, h))
            out.append(src if src >= max(oy, 0) else -1)
    return out


@pytest.mark.parametrize("b,h,w,grid", [(1, 16, 16, 132), (3, 64, 16, 2), (2, 48, 32, 3),
                                        (1, 720, 1280, 132), (4, 512, 512, 132), (1, 32, 16, 1),
                                        (2, 80, 48, 5), (1, 16, 1280, 7), (3, 144, 64, 4),
                                        (1, 96, 96, 132)])
def test_head_tile_plan_writes_each_output_once(b, h, w, grid):
    """Every pooled output is stored once; every e1 row a stored output
    reads holds the reflected image row the plain conv reads, at the image's
    edges too (a 32-row tile on a 16- or 48-row image reaches below it)."""
    written, e1_reads = _head_plan(b, h, w, grid)
    assert (written == 1).all()
    fixed_rows = {y0: _fixed_e1_rows(y0, h) for y0 in range(0, h, ROWS)}
    for y0, y, region_row in e1_reads:
        if y >= h:
            continue
        fixed = fixed_rows[y0]
        dy = region_row - (y - y0)
        assert fixed[region_row] == int(_reflect(y + dy - 1, h))


def _head_rgb_rows(y0, h, rows=ROWS):
    """The image rows ``load_rgb`` copies for a tile: rows y0-2 .. reflected,
    then kept in [0, h) (``min(max(reflect(...), 0), h - 1)``)."""
    return np.clip(_reflect(y0 - 2 + np.arange(rows + 4), h), 0, h - 1)


@pytest.mark.parametrize("h", [16, 32, 48, 80, 720, 1024])
def test_head_rgb_rows_stay_in_the_image(h):
    """A 32-row tile on a 16-row image reaches rows past twice the image's
    height, whose reflection falls above the image; the copy keeps every
    row it reads inside the image (an address outside it faulted on the
    card), and the rows the image's outputs read are the reflected ones."""
    for y0 in range(0, h, ROWS):
        g = y0 - 2 + np.arange(ROWS + 4)
        got = _head_rgb_rows(y0, h)
        assert ((got >= 0) & (got < h)).all()
        needed = g <= h  # rows -1 .. h feed e1 rows 0 .. h - 1
        np.testing.assert_array_equal(got[needed & (g >= -1)], _reflect(g, h)[needed & (g >= -1)])
    if h == 16:
        assert (_reflect(np.arange(-2, 34), h) < 0).any()


@pytest.mark.parametrize("h,w", [(16, 16), (48, 32), (720, 1280), (32, 16), (80, 48),
                                 (64, 1280)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_head_rgb_tile_is_the_reflected_image(dtype, h, w):
    """The rgb tile of every tile, as ``load_rgb`` copies it (rows
    reflected, then kept in the image; f32 columns reflected, bf16 whole
    16-byte column runs x0-8 .. x0+23 where they lie in the image, then
    reflected by ``convert_rgb``), holds at every pixel an in-image e1
    output reads the reflected image pixel."""
    rng = np.random.default_rng(7)
    img = rng.random((3, h, w)).astype(np.float32)
    # the tiles along the image's edges and next to them, where reflections act
    rows = ROWS
    y0s = sorted({y for y in (0, rows, h - h % rows or h - rows, h - 2 * rows) if 0 <= y < h})
    x0s = sorted({x for x in (0, TILE, w - 2 * TILE, w - TILE) if 0 <= x < w})
    i = np.arange(rows + 2)[:, None, None, None]
    j = np.arange(18)[None, :, None, None]
    dy = np.arange(3)[None, None, :, None]
    dx = np.arange(3)[None, None, None, :]
    for y0 in y0s:
        for x0 in x0s:
            gy = _head_rgb_rows(y0, h)
            if dtype == torch.float32:
                tile = img[:, gy][:, :, _reflect(x0 - 2 + np.arange(20), w)]
            else:
                loaded = np.array([0 <= x0 - 8 + 8 * (c // 8) < w for c in range(32)])
                idx = _reflect(x0 - 2 + np.arange(20), w) - (x0 - 8)
                assert loaded[idx].all()
                raw = img[:, gy][:, :, np.clip(x0 - 8 + np.arange(32), 0, w - 1)]
                tile = raw[:, :, idx]
            # e1 rows y0-1 .. and columns x0-1 .. in the image read rgb rows
            # and columns one to either side
            ge, gxe = y0 - 1 + i, x0 - 1 + j
            inside = np.broadcast_to((ge >= 0) & (ge < h) & (gxe >= 0) & (gxe < w), (rows + 2, 18, 3, 3))
            got = tile[:, i + dy, j + dx]
            want = img[:, _reflect(ge + dy - 1, h), _reflect(gxe + dx - 1, w)]
            np.testing.assert_array_equal(got[:, inside], want[:, inside])


def _tail_reads(h, w, lead):
    """Per output pixel (y, x) and tap (dy, dx), the image row and column that
    the staged element the tail kernel's thread reads holds, and whether it
    holds one: a box element of the image's plane (rows 0 .. h - 1, columns
    0 .. w - 1), or a patched row (box row -1 takes row 1, row h takes
    h - 2). Other box elements (zeros outside the tensor, the next plane's
    rows) hold no pixel of the image."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    y0, x0 = (ys // TAIL) * TAIL, (xs // TAIL) * TAIL
    rg, o = ((ys - y0) // 4), (ys - y0) % 4
    xg, j = ((xs - x0) // 4), (xs - x0) % 4
    gx0 = x0 + 4 * xg
    rows_read, cols_read, holds = [], [], []
    for dy in range(3):
        g = y0 - 1 + 4 * rg + o + dy  # the image row of the box row read
        row = np.where(g == -1, 1, np.where(g == h, h - 2, g))
        row_ok = (g >= -1) & (g <= h) & (4 * rg + o + dy < TAIL + 2)
        for dx in range(3):
            c = j + dx - 1  # the thread's column offset: -1 .. 4
            col = np.where(c == -1,
                           np.where(gx0 == 0, gx0 + 1, gx0 - 1),
                           np.where(c == 4, np.where(gx0 + 4 == w, gx0 + 2, gx0 + 4), gx0 + c))
            box_col = col - x0 + lead
            rows_read.append(row)
            cols_read.append(col)
            holds.append(row_ok & (col >= 0) & (col < w) & (box_col >= 0) & (box_col < TAIL + 2 * lead))
    return np.stack(rows_read), np.stack(cols_read), np.stack(holds), ys, xs


@pytest.mark.parametrize("h,w", [(16, 16), (48, 32), (64, 16), (16, 80), (96, 144), (720, 1280),
                                 (512, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_tail_walk_reads_the_reflected_pixel(dtype, h, w):
    """Each output pixel belongs to one thread of one tile, and each of its
    nine taps reads a staged element holding the reflected image pixel the
    plain conv reads. The boxes fit the copy's rules in both types: a box
    starting on 16 bytes of the row, its rows a multiple of 16 bytes, each
    channel's box at a 128-byte boundary, and a thread's four columns one
    aligned shared load."""
    es, lead = ESIZE[dtype], LEAD[dtype]
    cols = TAIL + 2 * lead
    assert lead * es == 16 and cols * es % 16 == 0
    channel = -(-(TAIL + 2) * cols * es // 128) * 128
    assert channel % 128 == 0 and all((lead + 4 * xg) * es % (4 * es) == 0 for xg in range(16))
    owner = np.zeros((h, w), dtype=np.int64)
    for y0 in range(0, h, TAIL):
        for x0 in range(0, w, TAIL):
            for rg in range(16):
                for xg in range(16):
                    gx0 = x0 + 4 * xg
                    if gx0 >= w:
                        continue
                    for o in range(4):
                        y = y0 + 4 * rg + o
                        if y < h:
                            owner[y, gx0: gx0 + 4] += 1
    assert (owner == 1).all()
    rows, cols_read, holds, ys, xs = _tail_reads(h, w, lead)
    assert holds.all()
    for t in range(9):
        dy, dx = divmod(t, 3)
        np.testing.assert_array_equal(rows[t], _reflect(ys + dy - 1, h))
        np.testing.assert_array_equal(cols_read[t], _reflect(xs + dx - 1, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_tail_weights_as_the_kernel_lays_them_out(dtype):
    """The tail kernel's load of each image's OIHW weights, replayed: element
    i of [3][64][9] goes to shared [i % 576][i // 576] of [64][9][4], rounded
    to the operand type, co 3 zero; that is ``_taps(w, pad_co=4)`` of the
    rounded weights, and summed over (ci, dy, dx) in the kernel's order it
    gives the plain tail's conv."""
    rng = np.random.default_rng(17)
    w = torch.from_numpy((rng.standard_normal((2, 3, 64, 3, 3)) * 0.1).astype(np.float32))
    b = torch.from_numpy(rng.random((2, 3)).astype(np.float32))
    f = torch.from_numpy(rng.random((2, 64, 6, 5)).astype(np.float32)).to(dtype)
    for i in range(2):
        flat = w[i].reshape(-1).to(dtype).float().numpy()
        smem = np.zeros((64 * 9, 4), dtype=np.float32)
        n = np.arange(flat.size)
        smem[n % 576, n // 576] = flat
        np.testing.assert_array_equal(smem.reshape(64, 9, 4),
                                      junction._taps(w[i], pad_co=4, dtype=dtype).numpy())
        xp = F.pad(f[i: i + 1].float(), (1, 1, 1, 1), mode="reflect")[0].numpy().astype(np.float64)
        acc = np.zeros((3, 6, 5))
        for ci in range(64):
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                for co in range(3):
                    acc[co] += xp[ci, dy: dy + 6, dx: dx + 5] * smem[ci * 9 + tap, co]
        ref = junction._decoder_tail_plain(f[i: i + 1], w[i: i + 1], b[i: i + 1], False,
                                           acc=torch.float64)[0].double().numpy()
        got = acc + b[i].numpy()[:, None, None]
        if dtype == torch.bfloat16:  # one rounding, of the f32-class sum
            got = torch.from_numpy(got).to(torch.bfloat16).double().numpy()
            np.testing.assert_array_equal(got, ref)
        else:  # the plain version rounds its float64 sum to f32
            np.testing.assert_allclose(got, ref, rtol=2.0**-23, atol=0)


@pytest.mark.parametrize("h", [16, 48, 720])
def test_halo_fix_rule_reflects_the_rows_an_output_reads(h):
    """``fix_halo``'s row rule (conv_tiles.cuh, conv_tc.cuh): a region row
    outside the image takes its reflection when that lies in the region and
    in the image, and is left alone otherwise; replayed on every 34-row
    region of a 32-row tiling, rows the image's outputs read come out
    reflected, and no row is copied from outside the region."""
    for y0 in range(0, h, 32):
        oy, rows = y0 - 1, 34
        region = np.arange(oy, oy + rows)
        vals = region.astype(np.float64).copy()  # row i holds image row oy + i (or garbage)
        out = vals.copy()
        for i, gy in enumerate(region):
            if gy < 0 or gy >= h:
                src = int(_reflect(gy, h))
                if src >= max(oy, 0):
                    assert 0 <= src - oy < rows
                    out[i] = vals[src - oy]
        for y in range(y0, min(y0 + 32, h)):
            for dy in range(3):
                assert out[y - oy + dy - 1] == _reflect(y + dy - 1, h)
