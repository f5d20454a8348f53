"""Device mesh and sharding: data-parallel and height-sharded stylization.

Counterpart of ``wct_tpu/parallel/mesh.py``, with its single-controller
API: one process and one host thread drive every entry of a 1-D mesh,
``stylize_sharded`` and ``stylize_spatial`` take the global batch, and
``train.trainer.make_sharded_train_step`` returns a step over it. There
is no process per card and no collective library: a value that crosses
cards is copied by PyTorch, which orders the copy after the work queued
on both cards' current streams.

- ``create_mesh(n)`` lists ``n`` devices, cycling over the cards, so
  ``create_mesh(4)`` on one H100 is four shards of ``cuda:0`` (the
  counterpart of the JAX tests' ``--xla_force_host_platform_device_count``).
  Each entry has its own CUDA stream.
- ``shard_batch`` splits dim 0 in ``torch.tensor_split`` order (uneven
  splits allowed); ``shard_spatial`` splits the image height in whole
  blocks of rows; ``gather`` puts a ``Sharded`` value back together on
  the first device. ``batch_sharding``, ``replicated`` and
  ``spatial_sharding`` are the placements ``put`` takes.
- Parameters and style caches are copied once per distinct device and
  kept (``replicate``); shards of one device share the same tensors.
- ``stylize_sharded``: each shard runs ``cascade.stylize`` on its slice,
  so each shard's output is the same bits as ``stylize`` on the same
  images; ``stylize_spatial``: the cascade on an image split by height,
  with a halo exchange before every 3×3 conv and the level statistics
  combined over the shards.

Both sharded paths run with ``fuse_junction`` off, as the reference
does (``wct_tpu/parallel/mesh.py:106-112``), so both packages compute
the same math there. Everything is enqueued from one host thread: the
conv-choice tables (``ops.convs``), the launch counters and the kernel
loader are not safe across threads.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time

import torch
import torch.nn.functional as F

from wct_tpu_torch.models import cascade as cascade_lib
from wct_tpu_torch.models import decoder as dec_lib
from wct_tpu_torch.models import vgg
from wct_tpu_torch.ops import adain as adain_ops
from wct_tpu_torch.ops import gram
from wct_tpu_torch.ops import pack2
from wct_tpu_torch.ops import wct as wct_ops
from wct_tpu_torch.ops.convs import (
    compose_1x1_into_conv,
    conv2d_reflect_nchw,
    conv2d_reflect_perimage_nchw,
    conv2d_ring_rows_nchw,
    conv2d_valid_nchw,
    conv2d_valid_perimage_nchw,
    maxpool2_nchw,
    to_nhwc,
    upsample_nearest2_nchw,
)
from wct_tpu_torch.utils.device import resolve_device, set_numerics

# Rows per height block: the deepest level's pool factor, so every pool
# and upsample of the five-level cascade stays inside a shard.
SPATIAL_BLOCK = 16
# Trees (parameters, style caches) a mesh keeps copied per device; the
# oldest copy is dropped first.
_REPLICAS_KEPT = 16


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices`` (a device may repeat: virtual shards of one
    card), the axis name, one CUDA stream per entry (none on the CPU),
    the copies ``replicate`` keeps, and ``stylize_sharded``'s last
    per-shard times (``utils.profiling.shard_times`` reads them)."""

    devices: tuple[torch.device, ...]
    axis_name: str = "data"
    streams: tuple = dataclasses.field(default=(), compare=False, repr=False)
    replicas: collections.OrderedDict = dataclasses.field(
        default_factory=collections.OrderedDict, compare=False, repr=False)
    last_shard_times: list = dataclasses.field(default_factory=list, compare=False, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_name: len(self.devices)}


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a value goes on a mesh: split along ``dim`` (0: batch, 1: the
    height of ``[B, H, W, C]``, in blocks of ``block`` rows) or, with
    ``dim=None``, copied whole to every entry."""

    mesh: Mesh
    dim: int | None
    block: int = 1


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A tensor split over a mesh: one piece per entry, on its device (a
    piece may be empty), and the whole tensor's shape."""

    shards: tuple[torch.Tensor, ...]
    placement: Placement
    shape: tuple[int, ...]


def create_mesh(
    n_devices: int | None = None, axis_name: str = "data", device: str | torch.device = "cuda"
) -> Mesh:
    """A mesh of ``n_devices`` entries (by default one per card, or one
    CPU device). ``device="cuda"`` cycles over every card, ``"cuda:k"``
    over card k alone, ``"cpu"`` repeats the CPU; asking for CUDA without
    a card raises (``utils.device.resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        pool = ([dev] if dev.index is not None
                else [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    else:
        pool = [dev]
    n = len(pool) if n_devices is None else n_devices
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got n_devices={n_devices}")
    devices = tuple(pool[i % len(pool)] for i in range(n))
    streams = tuple(torch.cuda.Stream(device=d) for d in devices) if dev.type == "cuda" else ()
    return Mesh(devices=devices, axis_name=axis_name, streams=streams)


def batch_sharding(mesh: Mesh, axis_name: str = "data") -> Placement:
    """Split a ``[B, ...]`` value's leading dim over the mesh."""
    check_axis(mesh, axis_name)
    return Placement(mesh, 0)


def replicated(mesh: Mesh) -> Placement:
    """A whole copy on every entry (parameters, style caches)."""
    return Placement(mesh, None)


def spatial_sharding(mesh: Mesh, axis_name: str = "data", block: int = SPATIAL_BLOCK) -> Placement:
    """Split the height (dim 1) of ``[B, H, W, C]`` in whole blocks of ``block`` rows."""
    check_axis(mesh, axis_name)
    return Placement(mesh, 1, block)


def check_axis(mesh: Mesh, axis_name: str) -> None:
    if axis_name != mesh.axis_name:
        raise ValueError(f"mesh axis is {mesh.axis_name!r}, not {axis_name!r}")


def _height_rows(h: int, n: int, block: int) -> list[int]:
    """Rows of each of ``n`` shards of height ``h``: whole blocks, as even
    as the blocks allow, the first shards taking one more (the last block
    may be short when ``block`` does not divide ``h``)."""
    blocks = -(-h // block)
    if blocks < n:
        raise ValueError(f"{h} rows make {blocks} blocks of {block}: too few for {n} shards")
    counts = [blocks // n + (i < blocks % n) for i in range(n)]
    rows = [c * block for c in counts]
    rows[-1] -= blocks * block - h
    return rows


def put(x, placement: Placement):
    """``x`` placed on the mesh: a ``Sharded`` value for a split placement,
    a tuple of per-entry trees (``replicate``) for ``replicated``."""
    mesh = placement.mesh
    if placement.dim is None:
        return tuple(replicate(mesh, x, d) for d in mesh.devices)
    if isinstance(x, Sharded):
        x = gather(x)
    x = torch.as_tensor(x)
    n = len(mesh.devices)
    if placement.dim == 0:
        pieces = torch.tensor_split(x, n, dim=0)
    else:
        pieces = torch.split(x, _height_rows(x.shape[1], n, placement.block), dim=1)
    return Sharded(tuple(p.to(d) for p, d in zip(pieces, mesh.devices)), placement,
                   tuple(x.shape))


def shard_batch(x, mesh: Mesh, axis_name: str = "data") -> Sharded:
    """Place a batch on the mesh, split over its leading dim."""
    return put(x, batch_sharding(mesh, axis_name))


def shard_spatial(x, mesh: Mesh, axis_name: str = "data", block: int = SPATIAL_BLOCK) -> Sharded:
    """Place images ``[B, H, W, C]`` on the mesh split over their height in
    whole blocks of ``block`` rows (raises when there are fewer blocks
    than entries)."""
    return put(x, spatial_sharding(mesh, axis_name, block))


def gather(x: Sharded) -> torch.Tensor:
    """The whole tensor of ``x`` on the mesh's first device."""
    dev = x.placement.mesh.devices[0]
    return torch.cat([s.to(dev) for s in x.shards], dim=x.placement.dim)


def _to(obj, dev: torch.device):
    """``obj``'s tensors on ``dev`` (those already there are not copied),
    through dicts, lists, tuples and dataclasses."""
    if torch.is_tensor(obj):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {k: _to(v, dev) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to(v, dev) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(
            obj, **{f.name: _to(getattr(obj, f.name), dev) for f in dataclasses.fields(obj)})
    return obj


def replicate(mesh: Mesh, tree, dev: torch.device):
    """``tree`` (parameters, a style cache) on ``dev``, copied once per
    tree and device and kept on the mesh for later calls. A tree is known
    by identity: one changed in place must be passed as a new object."""
    key = (id(tree), dev)
    hit = mesh.replicas.get(key)
    if hit is not None and hit[0] is tree:
        mesh.replicas.move_to_end(key)
        return hit[1]
    copy = _to(tree, dev)
    mesh.replicas[key] = (tree, copy)
    while len(mesh.replicas) > _REPLICAS_KEPT:
        mesh.replicas.popitem(last=False)
    return copy


def _tensors(obj) -> list[torch.Tensor]:
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    return []


@contextlib.contextmanager
def _on_entry(mesh: Mesh, i: int, inputs=()):
    """Run the block on entry ``i``'s stream (on the CPU, as it is). The
    stream first waits for its device's current stream, where the inputs
    were made, and the CUDA tensors of ``inputs`` are marked as used on it."""
    if not mesh.streams:
        yield
        return
    stream = mesh.streams[i]
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    for t in _tensors(inputs):
        if t.is_cuda:
            t.record_stream(stream)
    with torch.cuda.stream(stream):
        yield


def _join_entry(mesh: Mesh, i: int, outputs) -> None:
    """Make entry ``i``'s device's current stream wait for the entry's
    stream, and mark the CUDA tensors of ``outputs`` as used there."""
    if not mesh.streams:
        return
    stream = mesh.streams[i]
    current = torch.cuda.current_stream(stream.device)
    current.wait_stream(stream)
    for t in _tensors(outputs):
        if t.is_cuda:
            t.record_stream(current)


def each(mesh: Mesh, fn, *per_entry, times: list | None = None) -> list:
    """``fn(i, *args_i)`` for every entry i, each on its stream, the
    results joined back to the current streams. ``per_entry`` holds one
    sequence per argument, indexed by entry. ``times`` collects each
    entry's host enqueue seconds and, on the card, timing events around
    its work on its stream."""
    outs = []
    for i in range(len(mesh.devices)):
        args = [a[i] for a in per_entry]
        with _on_entry(mesh, i, args):
            if times is not None:
                start = torch.cuda.Event(enable_timing=True) if mesh.streams else None
                if start is not None:
                    start.record()
                t0 = time.perf_counter()
            outs.append(fn(i, *args))
            if times is not None:
                enqueue = time.perf_counter() - t0
                end = None
                if start is not None:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                times.append({"entry": i, "enqueue_s": enqueue, "start": start, "end": end})
    for i, out in enumerate(outs):
        _join_entry(mesh, i, out)
    return outs


def _unfused(cfg: cascade_lib.CascadeConfig) -> cascade_lib.CascadeConfig:
    """The sharded paths run the unfused cascade (the same math), as the
    reference's do (GSPMD cannot partition a ``pallas_call``), so the two
    packages compute the same thing there."""
    return dataclasses.replace(cfg, fuse_junction=False) if cfg.fuse_junction else cfg


@torch.no_grad()
def stylize_sharded(
    params: dict,
    content,
    style_cache: cascade_lib.StyleCache,
    alpha,
    cfg: cascade_lib.CascadeConfig,
    mesh: Mesh,
    axis_name: str = "data",
) -> torch.Tensor:
    """Data-parallel cascade over the mesh (BASELINE config 4).

    The batch splits over the entries (``shard_batch``; a ``Sharded``
    value from it is taken as it is); parameters and the style cache are
    replicated. Each non-empty shard runs ``cascade.stylize`` on its
    entry's stream, so its output is the same bits as ``stylize`` on the
    same images (the cascade has no cross-image math). Returns the
    whole ``[B, H, W, 3]`` on the first device.

    ``pack2_junction``, as the reference (``wct_tpu/parallel/mesh.py:118-139``):
    when the batch divides the mesh each shard keeps it, and its
    ``b % 2`` gate reads the shard's own batch; otherwise every shard
    runs unpacked. The port drops the scopes with the flag, where the
    reference's ``dataclasses.replace`` would raise on a scoped config.
    """
    cfg = _unfused(cfg)
    x = content if isinstance(content, Sharded) else shard_batch(content, mesh, axis_name)
    if x.placement.dim != 0:
        raise ValueError("stylize_sharded takes a batch-sharded value (shard_batch)")
    if cfg.pack2_junction and x.shape[0] % len(mesh.devices):
        cfg = dataclasses.replace(cfg, pack2_junction=False, pack2_tail_only=False,
                                  pack2_junction_only=False)
    live = [i for i, s in enumerate(x.shards) if s.shape[0]]
    devs = mesh.devices
    params_of = {i: replicate(mesh, params, devs[i]) for i in live}
    cache_of = {i: replicate(mesh, style_cache, devs[i]) for i in live}

    def run(i, xs):
        if not xs.shape[0]:
            return xs
        return cascade_lib.stylize(params_of[i], xs, cache_of[i], alpha, cfg)

    mesh.last_shard_times.clear()
    outs = each(mesh, run, x.shards, times=mesh.last_shard_times)
    return torch.cat([outs[i].to(devs[0]) for i in live])


# ---------------------------------------------------------------------------
# Height sharding
# ---------------------------------------------------------------------------


def _row_of(xs: list[torch.Tensor], g: int, dev: torch.device) -> torch.Tensor:
    """Global row ``g`` of NCHW shards ``xs`` (split along H), on ``dev``."""
    for x in xs:
        if g < x.shape[2]:
            return x[:, :, g:g + 1].to(dev)
        g -= x.shape[2]
    raise IndexError("row beyond the sharded map")


def _halo_conv(mesh: Mesh, xs: list, wb: list, relu: bool, ring: bool = False,
               perimage: bool = False) -> list:
    """A reflect-padded conv (+ ReLU) of a map split by height: each shard
    takes its neighbours' edge rows (at the image's top and bottom the
    reflected rows 1 and H − 2, from whichever shard holds them), pads its
    width by reflection and runs the VALID conv. A 1×1 conv needs no halo.

    ``ring``: the width's reflect pad gives way to the ring conv's
    (``convs.conv2d_ring_rows_nchw``: zero-padded bulk, side strips, and
    the ring's row strip where the shard holds the image's top or bottom
    edge). ``perimage``: ``wb`` holds per-image weights ``(w [B, Co, Ci,
    k, k], b [B, Co])``, the folded transform's
    (``convs.conv2d_valid_perimage_nchw`` on the halo rows)."""
    k = wb[0][0].shape[-1]
    if k == 1:
        tops = bottoms = [None] * len(xs)
    else:
        if k != 3:
            raise ValueError(f"halo exchange for 3×3 and 1×1 convs only, got {k}×{k}")
        h = sum(x.shape[2] for x in xs)
        if h < 2:
            raise ValueError(f"a reflect pad needs 2 rows, the map has {h}")
        tops, bottoms, start = [], [], 0
        for s, x in enumerate(xs):
            end = start + x.shape[2]
            tops.append(_row_of(xs, start - 1 if s else 1, x.device))
            bottoms.append(_row_of(xs, end if s < len(xs) - 1 else h - 2, x.device))
            start = end

    last = len(xs) - 1

    def conv(i, x, top, bottom):
        if top is None:
            y = (conv2d_reflect_perimage_nchw if perimage else conv2d_reflect_nchw)(x, *wb[i])
        elif ring:
            xh = torch.cat([top, x, bottom], dim=2)
            y = conv2d_ring_rows_nchw(xh, *wb[i], top_edge=i == 0, bottom_edge=i == last)
        else:
            xp = F.pad(torch.cat([top, x, bottom], dim=2), (1, 1, 0, 0), mode="reflect")
            y = (conv2d_valid_perimage_nchw if perimage else conv2d_valid_nchw)(xp, *wb[i])
        return torch.relu(y) if relu else y

    return each(mesh, conv, xs, tops, bottoms)


def _per_device(mesh: Mesh, make) -> list:
    """``make(dev)`` once for each distinct device of the mesh, listed per entry."""
    made = {}
    for d in mesh.devices:
        if d not in made:
            made[d] = make(d)
    return [made[d] for d in mesh.devices]


def _tier_weights(enc: dict, compose_pre: bool, paired: bool) -> dict:
    """The encoder's full-resolution convs on one device, name → ``(w, b)``:
    conv1_1 with the 1×1 conv0 composed in (``compose_pre``; conv0 is then
    absent), each as its block-diagonal pair (``pack2.pair_weights``) when
    ``paired``."""
    wb = {n: (enc[n]["w"], enc[n]["b"]) for n in ("conv0", "conv1_1", "conv1_2")}
    if compose_pre:
        wb["conv1_1"] = compose_1x1_into_conv(*wb.pop("conv0"), *wb["conv1_1"])
    return {n: pack2.pair_weights(*v) for n, v in wb.items()} if paired else wb


def _pack_each(mesh: Mesh, xs: list) -> list:
    return each(mesh, lambda i, x: pack2.pack(x), xs)


def _unpack_each(mesh: Mesh, xs: list) -> list:
    return each(mesh, lambda i, x: pack2.unpack(x), xs)


def _encode(mesh: Mesh, enc: list, tier: list, xs: list, target: str, ring: bool = False,
            paired: bool = False) -> list:
    """``vgg.encode_multi_nchw(..., (target,))`` on a height-split map:
    the same layer list, shard by shard. ``tier`` holds each entry's
    full-resolution convs (``_tier_weights``, made once per device and
    call). ``paired``: those are the block-diagonal pairs and ``xs`` comes
    packed (``pack2.pack``), so conv0, conv1_1 and, above relu1_1, conv1_2
    and pool1 run on image pairs, and the map is unpacked after pool1;
    relu1_1 features are returned packed."""
    for spec in vgg.layers_to(target):
        if spec[0] == "pool":
            xs = each(mesh, lambda i, x: maxpool2_nchw(x), xs)
            if paired:
                xs, paired = _unpack_each(mesh, xs), False
            continue
        name = spec[1]
        if name in tier[0]:
            wb = [t[name] for t in tier]
        elif name == "conv0":  # composed into conv1_1
            continue
        else:
            wb = [(e[name]["w"], e[name]["b"]) for e in enc]
        xs = _halo_conv(mesh, xs, wb, relu=spec[0] == "conv", ring=ring)
    return xs


def _decode(mesh: Mesh, dec: list, xs: list, target: str, ring: bool = False,
            start: int = 0, pairs: list | None = None) -> list:
    """``decoder.decode_nchw`` on a height-split map, from layer ``start``.
    ``pairs``: each entry's block-diagonal pairs of the last tier's two
    convs (``_decoder_pairs``); the map is packed before the last
    upsample, that tier runs on image pairs, and the RGB comes out packed,
    as ``pack2.junction_pack2`` runs it."""
    layers = dec_lib.decoder_layers(target)
    for li in range(start, len(layers)):
        spec = layers[li]
        if pairs is not None and li == len(layers) - 3:
            xs = _pack_each(mesh, xs)
        if spec[0] == "upsample":
            xs = each(mesh, lambda i, x: upsample_nearest2_nchw(x), xs)
            continue
        if pairs is not None and spec[1] in pairs[0]:
            wb = [p[spec[1]] for p in pairs]
        else:
            wb = [(d[spec[1]]["w"], d[spec[1]]["b"]) for d in dec]
        xs = _halo_conv(mesh, xs, wb, relu=li != len(layers) - 1, ring=ring)
    return xs


def _decoder_pairs(decoders: dict, level: str) -> dict:
    """The ``level`` decoder's convs that run on image pairs, name → the
    block-diagonal ``(w, b)``: the last tier's two (64→64, 64→3), or
    relu1_1's one 64→3."""
    convs = [s[1] for s in dec_lib.decoder_layers(level)[-2:] if s[0] == "conv"]
    return {n: pack2.pair_weights(decoders[level][n]["w"], decoders[level][n]["b"])
            for n in convs}


def _decode_folded(mesh: Mesh, dec: list, feats: list, target: str, affine) -> list:
    """``decoder.decode_folded_nchw`` on a height-split map: the level's
    per-image affine ``(m, bias)`` (on the first device) folded into the
    first decoder conv once, that conv run per image on each shard's halo
    rows, then the rest of the decoder, unringed, as the cascade's folded
    decode runs it."""
    layers = dec_lib.decoder_layers(target)
    first = dec[0][layers[0][1]]
    w_fold, b_fold = dec_lib.fold_affine_into_conv(*affine, first["w"], first["b"])
    wb = [(w_fold.to(d), b_fold.to(d)) for d in mesh.devices]
    xs = _halo_conv(mesh, feats, wb, relu=len(layers) > 1, perimage=True)
    return _decode(mesh, dec, xs, target, start=1)


def combine_moments(sums, means, counts):
    """Chan's pairwise rule over parts, in part order: part s has
    ``counts[s]`` columns, mean ``means[s] [..., C]`` and centred sum of
    outer products ``sums[s] [..., C, C]`` (or of squares, ``[..., C]``).
    Returns ``(sum, mean, count)`` of the whole:
    μ = Σ n_s μ_s / n and M2 = Σ [M2_s + n_s (μ_s − μ)(μ_s − μ)ᵀ]."""
    n = sum(counts)
    mean = sum(c * m for c, m in zip(counts, means)) / n
    total = None
    for c, m, s in zip(counts, means, sums):
        d = m - mean
        term = s + c * (d[..., :, None] * d[..., None, :] if s.dim() > d.dim() else d * d)
        total = term if total is None else total + term
    return total, mean, n


def _columns(f: torch.Tensor) -> int:
    return math.prod(f.shape[2:])


def sharded_covariance(mesh: Mesh, feats: list, groups: int = 1):
    """The channel covariances of a map split by height (``feats``: NCHW
    shards, one per entry, or their channel-major ``[B, C, N_s]`` views):
    ``gram.centered_gram_cn`` per shard on its ``[B·G, C/G, N_s]`` view (as
    ``ops.wct._grouped_gram_cn``), combined on the first device by
    ``combine_moments``: ``(cov [B·G, C/G, C/G], mean [B·G, C/G])``, N − 1
    normalised as ``ops.wct._gram_cn``."""

    def one(i, f):
        b, c = f.shape[:2]
        return gram.centered_gram_cn(f.reshape(b * groups, c // groups, -1).contiguous())

    parts = each(mesh, one, feats)
    dev = mesh.devices[0]
    total, mean, n = combine_moments([g.to(dev) for g, _ in parts],
                                     [m.to(dev) for _, m in parts],
                                     [_columns(f) for f in feats])
    return total / (n - 1), mean


def _shard_moments(mesh: Mesh, feats: list):
    """AdaIN's content moments ``(mean, population var)`` ``[B, C]`` of a
    height-split map (or its ``[B, C, N_s]`` views): ``gram.moments_cn``
    per shard, combined."""
    parts = each(mesh, lambda i, f: gram.moments_cn(f.flatten(2)), feats)
    dev = mesh.devices[0]
    counts = [_columns(f) for f in feats]
    total, mean, n = combine_moments([(v * c).to(dev) for (_, v), c in zip(parts, counts)],
                                     [m.to(dev) for m, _ in parts], counts)
    return mean, total / n


def _split_rows(mesh: Mesh, x: torch.Tensor, rows: list[int]) -> list:
    return [p.to(d).contiguous() for p, d in zip(torch.split(x, rows, dim=2), mesh.devices)]


def _transform(mesh: Mesh, feats: list, level: str, caches: list, alpha, cfg) -> list:
    """The level's transform on a height-split map (NCHW shards or their
    ``[B, C, N_s]`` views), from statistics combined over the shards: the
    WCT affine (dense or in blocks) or AdaIN's moments, computed once and
    applied per shard; at relu5_1 with ``swap5``, the whole whitened map
    on the first device."""
    kw = cascade_lib.wct_kw(cfg, level)
    style = caches[0][level]
    if cfg.swap5 and level == "relu5_1":
        cov, mean = sharded_covariance(mesh, feats, 1)
        w_c, mu_c = wct_ops.whitening_kernel_from_cov(cov, mean, **kw)
        whole = torch.cat([f.to(mesh.devices[0]) for f in feats], dim=2)
        out = cascade_lib.swap_level(whole, w_c, mu_c, style, alpha, cfg)
        return _split_rows(mesh, out, [f.shape[2] for f in feats])
    if cfg.transform == "adain":
        mu, var = _shard_moments(mesh, feats)
        mus, vars_ = ([t.to(d) for d in mesh.devices] for t in (mu, var))
        return each(mesh, lambda i, f, m, v: adain_ops.adain_apply_cn(
            f.flatten(2), m, v, caches[i][level].adain, alpha).reshape(f.shape), feats, mus, vars_)
    cov, mean = sharded_covariance(mesh, feats, cfg.wct_groups)
    blended, bias = wct_ops.wct_affine_from_cov(cov, mean, style.stats, alpha, **kw)
    ms, bs = ([t.to(d) for d in mesh.devices] for t in (blended, bias))
    return each(mesh, lambda i, f, m, b: wct_ops.apply_affine_cn(f.flatten(2), m, b).reshape(f.shape),
                feats, ms, bs)


def _tail_pack2(mesh: Mesh, feats: list, caches: list, alpha, cfg, pairs: list) -> list:
    """``pack2.tail_pack2`` on packed relu1_1 shards ``[B/2, 128, h_s, W]``:
    the statistics of each shard's images view (``pack2.images_view``,
    ``[B, 64, N_s]``, pair j's halves at entries 2j and 2j + 1) combined
    over the shards, the transform applied per shard on the same view, so
    the pair Gram's cross blocks are never formed, then the 64→3 conv as
    the packed 128→6 conv (``pairs``) over the halo rows. Returns the
    unpacked RGB shards, unclipped."""
    views = each(mesh, lambda i, f: pack2.images_view(f), feats)
    moved = _transform(mesh, views, "relu1_1", caches, alpha, cfg)
    ys = each(mesh, lambda i, v, f: v.reshape(f.shape), moved, feats)
    name = dec_lib.decoder_layers("relu1_1")[-1][1]
    return _unpack_each(mesh, _halo_conv(mesh, ys, [p[name] for p in pairs], relu=False,
                                         ring=cfg.ring_conv))


def _affine(mesh: Mesh, feats: list, level: str, caches: list, alpha, cfg):
    """The level's per-image affine for the fold, from statistics combined
    over the shards, on the first device: AdaIN's diagonal ``(scale,
    bias)`` or the WCT's dense ``(M, bias)`` (``cascade._level_affine``)."""
    style = caches[0][level]
    if cfg.transform == "adain":
        return adain_ops.adain_affine_from_moments(*_shard_moments(mesh, feats), style.adain, alpha)
    cov, mean = sharded_covariance(mesh, feats, cfg.wct_groups)
    blended, bias = wct_ops.wct_affine_from_cov(
        cov, mean, style.stats, alpha, **cascade_lib.wct_kw(cfg, level))
    return wct_ops.dense_affine(blended), bias


@dataclasses.dataclass(frozen=True)
class Pack2Plan:
    """Which layers of ``stylize_spatial``'s walk run on image pairs, one
    entry per level of ``cfg.relu_targets`` (the same in every pass):
    ``encoder``, its full-resolution tier (conv0, conv1_1 and, above
    relu1_1, conv1_2 and pool1); ``decoder``, its last tier (the last
    upsample and the two convs after it), whose packed RGB the next
    level's encoder takes as it is; ``tail``, relu1_1's statistics on the
    packed map's images view and its 64→3 conv as the packed 128→6 conv."""

    encoder: tuple[bool, ...]
    decoder: tuple[bool, ...]
    tail: tuple[bool, ...]


def pack2_plan(cfg: cascade_lib.CascadeConfig, batch: int) -> Pack2Plan:
    """The layers the unsharded cascade runs on image pairs for ``cfg`` and
    a batch of ``batch`` (``models/cascade.py::stylize_fn``'s gates, after
    ``wct_tpu/models/cascade.py:477-566``), for a walk that re-encodes
    from RGB at every level: a packed junction there is the decoder's last
    tier and the next level's encoder tier, the layers
    ``pack2.junction_pack2`` runs, in its order."""
    pack2_all = cfg.pack2_junction and batch % 2 == 0
    pack2_ok = pack2_all and not cfg.pack2_tail_only
    pack_tail_ok = (pack2_all and cfg.wct_groups == 1 and not cfg.pack2_junction_only
                    and len(dec_lib.decoder_layers("relu1_1")) == 1)
    targets = cfg.relu_targets
    encoder, decoder, tail = [], [], []
    junction = False  # the previous level's decoder ended in a packed junction
    # (CascadeConfig refuses pack2 with fold_transform, so no level folds.)
    for li, level in enumerate(targets):
        tail.append(level == "relu1_1" and pack_tail_ok)
        encoder.append(tail[-1] or junction or (pack2_ok and level != "relu1_1"))
        junction = (pack2_ok and not tail[-1] and li + 1 < len(targets)
                    and dec_lib.has_standard_tail(level))
        decoder.append(junction)
    return Pack2Plan(tuple(encoder), tuple(decoder), tuple(tail))


@torch.no_grad()
def encode_spatial(
    encoder_params: dict, images, target: str, mesh: Mesh, axis_name: str = "sp",
    compose_pre: bool = False,
) -> torch.Tensor:
    """``vgg.encode`` of ``images [B, H, W, 3]`` split by height over the mesh
    (the halo conv stack of ``stylize_spatial``), gathered on the first
    device as ``[B, h, w, C]``. H must split into whole blocks of the
    target's pool factor."""
    check_axis(mesh, axis_name)
    devs = mesh.devices
    x = torch.as_tensor(images, dtype=torch.float32, device=devs[0]).permute(0, 3, 1, 2)
    block = vgg.TARGET_SCALE[target]
    if x.shape[2] % block:
        raise ValueError(f"height {x.shape[2]} is not a multiple of {target}'s pool factor {block}")
    xs = _split_rows(mesh, x, _height_rows(x.shape[2], len(devs), block))
    enc = [replicate(mesh, encoder_params, d) for d in devs]
    tier = _per_device(mesh, lambda d: _tier_weights(replicate(mesh, encoder_params, d),
                                                     compose_pre, False))
    feats = _encode(mesh, enc, tier, xs, target)
    return to_nhwc(torch.cat([f.to(devs[0]) for f in feats], dim=2))


@torch.no_grad()
def stylize_spatial(
    params: dict,
    content,
    style_cache: cascade_lib.StyleCache,
    alpha,
    cfg: cascade_lib.CascadeConfig,
    mesh: Mesh,
    axis_name: str = "sp",
) -> torch.Tensor:
    """Height-sharded cascade, for images too large for one card.

    The image is padded as ``cascade.stylize_fn`` pads it, split over the
    entries in whole blocks of the deepest level's pool factor (so pools
    and upsamples stay local), and walked through the same encoder and
    decoder layer lists shard by shard, with a halo exchange before every
    3×3 conv. Each level's content statistics are ``centered_gram_cn``
    (on the card, the kernel) per shard, combined in shard order by
    Chan's rule; the WCT's affine (or AdaIN's moments) is computed once
    and applied per shard; ``swap5`` gathers the relu5_1 map to the first
    device and runs the style-swap there, exact for any patch and
    stride. Returns the whole ``[B, H, W, 3]`` on the first device.

    Caveat (as the reference's): the combined Gram sums in another order,
    and the WCT's hard eigenvalue mask at ``trunc`` is discontinuous, so a
    covariance with eigenvalues near the threshold can keep other modes
    than the unsharded path. Outputs are valid stylizations and
    deterministic for a fixed mesh, but not bitwise equal to the
    unsharded result; use ``stylize_sharded`` where bits must match.

    The layout rewrites run as the reference's sharded cascade runs them
    (it turns off ``fuse_junction`` alone, ``wct_tpu/parallel/mesh.py:104-116``):

    - ``fold_transform``: at the levels of up to 128 channels (not the
      swap level) the combined statistics give each image's affine once,
      it is folded into the first decoder conv, and each shard runs the
      per-image weights over its halo rows; the rest of that decoder
      runs as the cascade's folded decode does, without the ring.
    - ``ring_conv``: every 3×3 conv keeps its row halos, and the width's
      reflect pad gives way to the ring conv's zero-padded bulk and
      column strips; a shard holding the image's top or bottom edge
      takes the ring's row strip there (``convs.conv2d_ring_rows_nchw``).
    - ``pack2_junction`` and its scopes: the layers the unsharded cascade
      runs on image pairs (``pack2_plan``, the reference's gates: an odd
      batch packs nothing) run so here, on each shard's rows with the
      block-diagonal weights, made once per device and call: the
      encoder's full-resolution tier, the decoder's last tier, whose
      packed RGB (clipped packed) goes on into the next level's encoder,
      and the relu1_1 tail, whose statistics come from each shard's
      images view (``_tail_pack2``).
    """
    check_axis(mesh, axis_name)
    cfg = _unfused(cfg)
    set_numerics(cfg.dtype)
    if isinstance(content, Sharded):
        content = gather(content)
    devs = mesh.devices
    x, h, w = cascade_lib.padded_input(content, cfg, devs[0])
    plan = pack2_plan(cfg, x.shape[0])
    block = max(vgg.TARGET_SCALE[t] for t in cfg.relu_targets)
    xs = _split_rows(mesh, x, _height_rows(x.shape[2], len(devs), block))
    enc = [replicate(mesh, params["encoder"], d) for d in devs]
    decs = [replicate(mesh, params["decoders"], d) for d in devs]
    caches = [replicate(mesh, style_cache, d) for d in devs]
    tiers = {paired: _per_device(mesh, lambda d, p=paired: _tier_weights(
        replicate(mesh, params["encoder"], d), cfg.compose_conv0, p)) for paired in set(plan.encoder)}
    pairs = {level: _per_device(mesh, lambda d, lv=level: _decoder_pairs(
        replicate(mesh, params["decoders"], d), lv))
        for li, level in enumerate(cfg.relu_targets) if plan.decoder[li] or plan.tail[li]}
    packed = False  # whether xs holds packed RGB, from a packed decoder tier
    for _ in range(cfg.passes):
        for li, level in enumerate(cfg.relu_targets):
            if plan.encoder[li] and not packed:
                xs = _pack_each(mesh, xs)
            feats = _encode(mesh, enc, tiers[plan.encoder[li]], xs, level, cfg.ring_conv,
                            paired=plan.encoder[li])
            dec = [d[level] for d in decs]
            if plan.tail[li]:
                xs = _tail_pack2(mesh, feats, caches, alpha, cfg, pairs[level])
            else:
                if plan.encoder[li] and level == "relu1_1":
                    feats = _unpack_each(mesh, feats)
                if (cfg.fold_transform and vgg.TARGET_CHANNELS[level] <= 128
                        and not (cfg.swap5 and level == "relu5_1")):
                    xs = _decode_folded(mesh, dec, feats, level,
                                        _affine(mesh, feats, level, caches, alpha, cfg))
                else:
                    feats = _transform(mesh, feats, level, caches, alpha, cfg)
                    xs = _decode(mesh, dec, feats, level, cfg.ring_conv,
                                 pairs=pairs[level] if plan.decoder[li] else None)
            packed = plan.decoder[li]
            if cfg.clip_between_levels:
                xs = each(mesh, lambda i, y: y.clamp(0.0, 1.0), xs)
    out = torch.cat([y.to(devs[0]) for y in xs], dim=2)
    return to_nhwc(out.clamp(0.0, 1.0)[:, :, :h, :w]).float()
