"""What the small-channel conv kernel's index plans compute, replayed on the CPU.

``csrc/conv3x3_small.cu`` walks tiles of 4 rows × 64 columns with
persistent blocks and stages each haloed tile channel-minor in shared
memory (a TMA box straight into the tile for NHWC with C_in = 8, 16, 32
or 64; raw rows turned channel-minor by ``ldmatrix.trans`` +
``stmatrix`` for NCHW, by 16-byte loads and a funnel shift for NHWC
with other C_in). It patches the edge tiles' halo from its reflections,
reads a tap's A operand through a ``wgmma`` descriptor that starts at
the shifted pixel, takes the weights it laid out itself through the
128-byte-swizzle descriptor, and stores the output tile by ``stmatrix``
and TMA tensor stores. These tests replay those index rules in numpy,
with the constants the source uses, the instructions' data movement as
PTX defines it (the swizzles following the address bits, as the card
showed), and TMA boxes filling zeros outside the tensor (a store drops
what lies outside), and hold the result to
``conv_small._conv3x3_small_plain``: every output written once, every
input the reflected pixel, the NHWC and NCHW tiles the same bits.
"""

import numpy as np
import pytest
import torch

from wct_tpu_torch.ops import conv_small

TILE_R, TILE_C = 4, 64  # kTileRows, kTileCols
HALO_R, HALO_C = TILE_R + 2, TILE_C + 2
RAW_COLS, RAW_BLOCKS = TILE_C + 24, 10  # NCHW raw rows x0-8 .. x0+79; blocks reaching the tile
PIECES = 5  # NHWC raw rows: boxes of 16 pixels
SBO, ROW = 1024, 128  # the weights' descriptor: atom stride and row bytes (csrc/conv_wgmma.cuh)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _swz(off, m):
    off = np.asarray(off)
    return off ^ (((off >> 7) & m) << 4)


def _plan(cin, cout):
    """SmallPlan's numbers that the index rules read."""
    g = 1 << (-(-cin // 8) - 1).bit_length()
    return {"g": g, "pix": 16 * g, "swz": {8: 7, 4: 3, 2: 1}.get(g, 0), "nchunks": -(-9 * g // 8),
            "co_pad": 8 if cout <= 8 else 64, "raw_piece": -(-HALO_R * 16 * cin * 2 // 128) * 128,
            "out_half": -(-TILE_R * 32 * cout * 2 // 128) * 128}


def _tiles(b, h, w):
    """(image, y0, x0) of every tile, in the order the blocks number them."""
    tiles_x = -(-w // TILE_C)
    per_image = tiles_x * (h // TILE_R)
    return [(t // per_image, (t % per_image) // tiles_x * TILE_R, (t % tiles_x) * TILE_C)
            for t in range(b * per_image)]


def _tma_load(g, box, coords, m):
    """A TMA box of the 3-D tensor ``g`` (indexed [d2][d1][d0]) at ``coords``
    (innermost first) as uint16 shared memory: dense in box order, zeros
    outside the tensor, the 16-byte units swizzled by ``m``."""
    b0, b1, b2 = box
    i2, i1, i0 = np.meshgrid(np.arange(b2), np.arange(b1), np.arange(b0), indexing="ij")
    c0, c1, c2 = i0 + coords[0], i1 + coords[1], i2 + coords[2]
    ok = (c0 >= 0) & (c0 < g.shape[2]) & (c1 >= 0) & (c1 < g.shape[1]) & (c2 >= 0) & (c2 < g.shape[0])
    vals = np.where(ok, g[np.clip(c2, 0, g.shape[0] - 1), np.clip(c1, 0, g.shape[1] - 1),
                          np.clip(c0, 0, g.shape[2] - 1)], 0).astype(np.uint16)
    out = np.zeros(b0 * b1 * b2, np.uint16)
    out[_swz(2 * np.arange(b0 * b1 * b2), m) // 2] = vals.ravel()
    return out


def _tma_store(g, smem, box, coords, m):
    """The inverse: the box in ``smem`` into ``g`` at ``coords``; what lies
    outside the tensor is dropped."""
    b0, b1, b2 = box
    i2, i1, i0 = np.meshgrid(np.arange(b2), np.arange(b1), np.arange(b0), indexing="ij")
    c0, c1, c2 = i0 + coords[0], i1 + coords[1], i2 + coords[2]
    ok = (c0 < g.shape[2]) & (c1 < g.shape[1]) & (c2 < g.shape[0])
    vals = smem[_swz(2 * np.arange(b0 * b1 * b2), m) // 2].reshape(b2, b1, b0)
    g[c2[ok], c1[ok], c0[ok]] = vals[ok]


def _bits(x):
    return x.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _as_f64(bits):
    return (np.asarray(bits).astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def _patch(tile, p, h, y0, x0, w):
    """patch_halo: an edge tile's halo pixels from their reflections."""
    top, bottom, left = y0 == 0, y0 + TILE_R == h, x0 == 0
    rcol = w - x0 + 1 if w - x0 + 1 < HALO_C else -1
    src = tile.copy()
    for r in range(HALO_R):
        for c in range(HALO_C):
            rr = 2 if top and r == 0 else HALO_R - 3 if bottom and r == HALO_R - 1 else r
            cc = 2 if left and c == 0 else rcol - 2 if c == rcol else c
            if (rr, cc) == (r, c):
                continue
            for cg in range(p["g"]):
                d = _swz((r * HALO_C + c) * p["pix"] + 16 * cg, p["swz"]) // 2
                s = _swz((rr * HALO_C + cc) * p["pix"] + 16 * cg, p["swz"]) // 2
                tile[d: d + 8] = src[s: s + 8]


def _stage(x_nchw, cin, cout, b, y0, x0, mode):
    """The tile a block stages for tile (b, y0, x0): ``mode`` "direct"
    (NHWC, C_in = 8 G), "nchw" or "nhwc_raw"; uint16 shared memory."""
    p = _plan(cin, cout)
    bsz, _, h, w = x_nchw.shape
    tile = np.zeros(-(-HALO_R * HALO_C * p["pix"] // 1024) * 512, np.uint16)
    if mode == "direct":
        g = _bits(x_nchw.permute(0, 2, 3, 1)).reshape(bsz * h, w, cin)
        box = _tma_load(g, (cin, HALO_C, HALO_R), (0, x0 - 1, b * h + y0 - 1), p["swz"])
        tile[: box.size] = box
    elif mode == "nchw":
        g = _bits(x_nchw[b].permute(1, 0, 2).contiguous())  # [H][C_in][W]: the 4-D map's image b
        raw = _tma_load(g, (RAW_COLS, cin, HALO_R), (x0 - 8, 0, y0 - 1), 0)  # [6][C_in][88]
        for it0 in range(0, HALO_R * RAW_BLOCKS * p["g"], 4):
            for it in range(it0, it0 + 4):
                k, r, cg = it % RAW_BLOCKS, it // RAW_BLOCKS % HALO_R, it // (RAW_BLOCKS * HALO_R)
                # ldmatrix.trans: the matrix's rows are 8 channels (zeros past C_in)
                m = np.zeros((8, 8), np.uint16)
                for rw in range(8):
                    ch = 8 * cg + rw
                    if ch < cin:
                        s = (r * cin + ch) * RAW_COLS + 8 * k
                        m[rw] = raw[s: s + 8]
                # stmatrix: row rw of the transpose to its pixel, or to the scratch row
                for rw in range(8):
                    col = 8 * k - 7 + rw
                    if 0 <= col < HALO_C:
                        d = _swz((r * HALO_C + col) * p["pix"] + 16 * cg, p["swz"]) // 2
                        tile[d: d + 8] = m[:, rw]
    else:
        g = _bits(x_nchw.permute(0, 2, 3, 1)).reshape(bsz * h, w * cin // 8, 8)
        piece = p["raw_piece"] // 2
        raw = np.zeros(PIECES * piece + 8, np.uint16)
        for q in range(PIECES):
            box = _tma_load(g, (8, 2 * cin, HALO_R), (0, (x0 // 8 - 1 + 2 * q) * cin, b * h + y0 - 1), 0)
            raw[q * piece: q * piece + box.size] = box
        words = raw.view(np.uint32)
        for cg in range(p["g"]):
            valid = cin - 8 * cg
            for px in range(HALO_R * HALO_C):
                o = [0, 0, 0, 0]
                if valid > 0:
                    r, rc = divmod(px, HALO_C)
                    rc += 7
                    q = rc // 16
                    e = (r * 16 + rc % 16) * cin + 8 * cg
                    u = q * piece // 2 + (e >> 3) * 4  # two 16-byte loads
                    wv = [int(v) for v in words[u: u + 8]]
                    s, ws = e & 7, (e & 7) >> 1
                    sel = [wv[k + ws] for k in range(5)]
                    for k in range(4):
                        v = ((sel[k] >> 16) | (sel[k + 1] << 16)) & 0xFFFFFFFF if s & 1 else sel[k]
                        o[k] = v if 2 * k + 1 < valid else v & 0xFFFF if 2 * k < valid else 0
                d = _swz(px * p["pix"] + 16 * cg, p["swz"]) // 2
                tile[d: d + 8] = np.array(o, np.uint32).view(np.uint16)
    _patch(tile, p, h, y0, x0, w)
    return tile


def _padded(x_nchw):
    return torch.nn.functional.pad(x_nchw.float(), (1, 1, 1, 1), mode="reflect")


def _case(b, h, w, cin, cout, seed=0):
    rng = np.random.default_rng(seed + cin + cout)
    x = torch.from_numpy(rng.standard_normal((b, cin, h, w)).astype(np.float32)).to(torch.bfloat16)
    wt = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3)) * 0.1).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(cout) * 0.1).astype(np.float32))
    return x, wt, bias


def _mode(cin):
    return "direct" if cin == 8 * _plan(cin, 1)["g"] else "nhwc_raw"


CASES = [  # (b, h, w, cin, cout): the trained shapes, partial tiles, odd channel counts
    (2, 8, 72, 64, 64), (1, 8, 8, 64, 3), (1, 8, 136, 3, 64), (2, 8, 40, 32, 8),
    (1, 8, 264, 5, 17), (1, 8, 40, 16, 24), (1, 8, 40, 17, 64), (1, 8, 40, 63, 5),
    (1, 8, 16, 8, 9),
]


@pytest.mark.parametrize("b,h,w,cin,cout", CASES)
def test_staged_tile_is_the_reflected_image(b, h, w, cin, cout):
    """Every staging form holds, at each halo pixel a stored output reads,
    the reflect-padded input, channels past C_in zero; the NCHW tile and
    the NHWC tile are the same bits, whole."""
    x = _case(b, h, w, cin, cout)[0]
    p = _plan(cin, cout)
    xp = _bits(_padded(x)).reshape(b, cin, h + 2, w + 2)
    for img, y0, x0 in _tiles(b, h, w):
        a = _stage(x, cin, cout, img, y0, x0, "nchw")
        np.testing.assert_array_equal(a, _stage(x, cin, cout, img, y0, x0, _mode(cin)))
        cols = min(HALO_C, w - x0 + 2)  # staged columns a stored output reads
        for cg in range(p["g"]):
            d = _swz((np.arange(HALO_R)[:, None] * HALO_C + np.arange(cols)[None]) * p["pix"]
                     + 16 * cg, p["swz"]) // 2
            got = a[d[..., None] + np.arange(8)]  # [row, col, channel]
            ch = 8 * cg + np.arange(8)
            want = np.zeros_like(got)
            live = ch < cin
            want[..., live] = xp[img][ch[live]][:, y0: y0 + HALO_R, x0: x0 + cols].transpose(1, 2, 0)
            np.testing.assert_array_equal(got, want)


def test_weight_layout_read_through_the_descriptor():
    """Each k-step's B, read as the 128-byte-swizzle descriptor reads it
    (chunk c at c · C_pad · 128, k-step j 32 bytes on), is the k-step's two
    k-groups of the OIHW weights rounded to bf16; N = 8 (C_out ≤ 8) rows in
    one atom; nothing else is non-zero."""
    for cin, cout in ((64, 64), (3, 64), (64, 3), (17, 5), (24, 40)):
        _, wt, _ = _case(1, 8, 8, cin, cout)
        p = _plan(cin, cout)
        lay = conv_small._weight_layout(wt)
        assert lay.size == p["nchunks"] * p["co_pad"] * 64
        wb = _bits(wt)
        seen = np.zeros(lay.size, bool)
        for kg in range(8 * p["nchunks"]):
            c, u = divmod(kg, 8)
            j, half = divmod(u, 2)
            n = np.arange(p["co_pad"])
            row = c * p["co_pad"] * 128 + (n // 8) * SBO + (n % 8) * ROW
            addr = _swz(row + 32 * j + 16 * half, 7)[:, None] // 2 + np.arange(8)[None]
            seen[addr] = True
            want = np.zeros((p["co_pad"], 8), np.uint16)
            if kg < 9 * p["g"]:
                tap, cg = divmod(kg, p["g"])
                ci = 8 * cg + np.arange(8)
                live = ci < cin
                want[:cout, live] = wb[:, ci[live], tap // 3, tap % 3]
            np.testing.assert_array_equal(lay[addr], want)
        assert seen.all()


def _a_operand(tile, p, r, s):
    """k-step s's A for tile row r as its descriptor reads it: 64 pixels from
    the tap's shifted start, K-major; G = 1 takes its second k-group (the
    next tap, or tap 8 again) at the leading byte offset."""
    g, pix = p["g"], p["pix"]
    kg = 2 * s
    tap, cg = divmod(kg, g)
    tapoff = lambda t: ((t // 3) * HALO_C + t % 3) * pix  # noqa: E731
    start = r * HALO_C * pix + tapoff(tap) + 16 * cg
    m, k = np.arange(64)[:, None], np.arange(16)[None]
    if g == 1:
        lbo = tapoff(min(tap + 1, 8)) - tapoff(tap)
        off = start + m * pix + np.where(k < 8, 2 * k, lbo + 2 * (k - 8))
    else:
        off = start + m * pix + 2 * k
    return _as_f64(tile[_swz(off, p["swz"]) // 2])


def _emulate(x, wt, bias, relu, mode):
    """The whole kernel on ``x`` (NCHW bf16) through the index plans: staged
    tiles, each tile row's A through its descriptors, the weights' B, the
    sum in float64 (the plans are under test, not the rounding), bias,
    ReLU, one rounding, the output slot as stmatrix writes it and the TMA
    stores. Returns [B, C_out, H, W] bf16 bits."""
    bsz, cin, h, w = x.shape
    cout = wt.shape[0]
    p = _plan(cin, cout)
    lay = conv_small._weight_layout(wt)
    co_pad, steps = p["co_pad"], (9 * p["g"] + 1) // 2
    n, k = np.arange(co_pad)[:, None], np.arange(16)[None]
    bmat = [_as_f64(lay[_swz((s // 4) * co_pad * 128 + (n // 8) * SBO + (n % 8) * ROW + 32 * (s % 4)
                             + 2 * k, 7) // 2]) for s in range(steps)]  # [co_pad, 16] each
    b64 = np.zeros(co_pad)
    b64[:cout] = bias.numpy()
    out_nhwc = np.zeros((bsz * h, w, cout), np.uint16)
    out_nchw = np.zeros((bsz * cout, h, w), np.uint16)
    for img, y0, x0 in _tiles(bsz, h, w):
        tile = _stage(x, cin, cout, img, y0, x0, mode)
        acc = np.stack([sum(_a_operand(tile, p, r, s) @ bmat[s].T for s in range(steps))
                        for r in range(TILE_R)]) + b64  # [row, pixel, channel]
        vals = _bits(torch.from_numpy((np.maximum(acc, 0) if relu else acc).astype(np.float32)))
        r, x_, ch = np.meshgrid(np.arange(TILE_R), np.arange(TILE_C), np.arange(co_pad), indexing="ij")
        if mode == "nchw":  # stmatrix.trans: [row][C_pad][64], 128-byte channel rows swizzled
            slot = np.zeros(TILE_R * co_pad * 64, np.uint16)
            slot[(r * co_pad * 128 + _swz(ch * 128 + 16 * (x_ // 8), 7) + 2 * (x_ % 8)) // 2] = vals
            for row in range(TILE_R):
                box = slot[row * co_pad * 64: row * co_pad * 64 + cout * 64]
                _tma_store(out_nchw, box, (TILE_C, 1, cout), (x0, y0 + row, img * cout), 7)
        elif cout == 64:  # stmatrix: [4][64][64], 128-byte pixels swizzled
            slot = np.zeros(TILE_R * TILE_C * 64, np.uint16)
            slot[(_swz((r * TILE_C + x_) * 128 + 16 * (ch // 8), 7) + 2 * (ch % 8)) // 2] = vals
            _tma_store(out_nhwc, slot, (64, TILE_C, TILE_R), (0, x0, img * h + y0), 7)
        else:  # two halves [4][32][C_out], a value at a time
            half = p["out_half"] // 2
            slot = np.zeros(2 * half, np.uint16)
            live = ch < cout
            slot[((x_ // 32) * half + (r * 32 + x_ % 32) * cout + ch)[live]] = vals[live]
            flat = out_nhwc.reshape(bsz * h, w * cout // 8, 8)
            _tma_store(flat, slot[:half], (8, 4 * cout, TILE_R), (0, x0 // 8 * cout, img * h + y0), 0)
            if x0 + 32 < w:
                _tma_store(flat, slot[half:], (8, 4 * cout, TILE_R),
                           (0, (x0 // 8 + 4) * cout, img * h + y0), 0)
    if mode == "nchw":
        return out_nchw.reshape(bsz, cout, h, w)
    return out_nhwc.reshape(bsz, h, w, cout).transpose(0, 3, 1, 2)


EMULATED = [(1, 8, 72, 64, 64, True), (2, 8, 8, 64, 3, False), (1, 8, 40, 3, 64, True),
            (1, 8, 40, 32, 8, False), (1, 8, 264, 5, 17, True), (1, 8, 40, 24, 64, False),
            (1, 8, 16, 16, 63, True)]


@pytest.mark.parametrize("b,h,w,cin,cout,relu", EMULATED)
def test_emulated_kernel_matches_plain(b, h, w, cin, cout, relu):
    """The replayed kernel, through either entry's staging and output form,
    within one bf16 ulp of ``_conv3x3_small_plain`` at every output, the
    two entries the same bits."""
    x, wt, bias = _case(b, h, w, cin, cout, seed=3)
    ref = conv_small._conv3x3_small_plain(x, wt, bias, relu).float().numpy().astype(np.float64)
    outs = []
    for mode in ("nchw", _mode(cin)):
        got = _as_f64(_emulate(x, wt, bias, relu, mode))
        limit = 2.0**-7 * np.abs(ref) + 1e-5 * np.abs(ref).max()
        assert (np.abs(got - ref) <= limit).all(), mode
        outs.append(got)
    np.testing.assert_array_equal(*outs)


@pytest.mark.parametrize("b,h,w", [(1, 8, 8), (2, 8, 40), (1, 16, 264), (3, 24, 72), (1, 720, 1280)])
def test_tile_plan_covers_each_output_once(b, h, w):
    """Persistent blocks (any grid) take tiles blockIdx + i · grid; the
    tiles, with the stores dropping columns past W, write every output
    once; the right halo column is patched exactly where W + 1 falls in
    the tile."""
    tiles = _tiles(b, h, w)
    written = np.zeros((b, h, w), np.int64)
    for grid in (1, 7, 132):
        written[:] = 0
        for blk in range(min(grid, len(tiles))):
            for t in range(blk, len(tiles), grid):
                img, y0, x0 = tiles[t]
                written[img, y0: y0 + TILE_R, x0: min(x0 + TILE_C, w)] += 1
        assert (written == 1).all()
    for _, _, x0 in tiles:
        rcol = w - x0 + 1 if w - x0 + 1 < HALO_C else -1
        assert (rcol >= 0) == (x0 + TILE_C >= w)
        assert rcol < 0 or 1 <= rcol - 2 <= w - x0 - 1


@pytest.mark.parametrize("cin,cout", [(64, 64), (3, 64), (64, 3), (63, 63), (1, 1), (17, 9)])
def test_shared_memory_plan_fits(cin, cout):
    """SmallPlan at the gate's corners: every form fits one block's 227 KB
    with at least one raw slot; the tile slots start on 1 KB (the 128-byte
    swizzle's atom)."""
    p = _plan(cin, cout)
    w_bytes = p["nchunks"] * p["co_pad"] * 128
    tile = -(-HALO_R * HALO_C * p["pix"] // 1024) * 1024
    for mode in ("direct", "nhwc_raw", "nchw"):
        raw = {"direct": 0, "nhwc_raw": PIECES * p["raw_piece"] + 16,
               "nchw": cin * HALO_R * RAW_COLS * 2}[mode]
        out = (TILE_R * p["co_pad"] * 128 if mode == "nchw"
               else TILE_R * TILE_C * 128 if cout == 64 else 2 * p["out_half"])
        total = (1024 + w_bytes + (2 if mode == "direct" else 1) * tile + -(-out // 1024) * 1024
                 + -(-raw // 128) * 128 + 48)
        assert w_bytes % 1024 == 0 and total <= 232448, (mode, total)
