#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100. It
builds every CUDA kernel of the port from ``wct_tpu_torch/csrc``, holds
each against its plain PyTorch version at the main path's shapes (and
at awkward ones), checks that the head's SASS holds HGMMA, splits the
junction's time per stage and checks that its SASS holds HGMMA
(``junction_stages``),
runs the five-level relu5_1 → relu1_1 cascade at
512 px on the trained ``weights/bundle.npz`` through
``precompute_style`` and ``stylize_microbatched`` five times: unfused
(``CascadeConfig(method="newton_schulz_pallas")``, phase ``main``), with
``fuse_junction=True`` (``main_fused``), in the bf16 throughput
configuration (``compute_dtype="bfloat16", method="newton_schulz_fast",
compose_conv0=True``, phase ``main_bf16``, which also sends the
cascade's own relu1_1-tier tensors through the small-conv and
centred-Gram entry points), in bf16 with ``fuse_junction=True``
(``main_bf16_fused``: the bf16 forms of the junction kernels), and in
the default ``CascadeConfig()`` (f32, ``eigh``, ``main_eigh``), whose
eigh kernel (``csrc/eigh_jacobi.cu``) phase ``eigh_kernel`` holds to its
twin, float64 and cuSOLVER's eigh and times; ``main`` also shows
``stylize_interp`` with new weights returning before the card is done.
Then the
other transforms: AdaIN unfused in f32 (``main_adain``) and fused in bf16
(``main_adain_fused``), style-swap at relu5_1 (``main_swap5``), grouped
WCT with four groups (``main_groups``) and the relative truncation
(``main_trunc``, one batch). Then the layout rewrites on the f32
Newton–Schulz-kernel route and the bf16 throughput route:
``fold_transform`` (``main_fold``: the route's gates and launch counts,
ms per frame in turns, the relu2_1 and relu1_1 decode stages, the
folded relu1_1 conv as one grouped conv beside ``decoder_tail_cuda``)
and ``ring_conv`` (``main_ring``: the same, peak bytes, and per conv
the share of interior elements equal to the padded conv's), and
``pack2_junction`` (``main_pack2``: both routes with pack2, and the f32
route with ``pack2_tail_only`` and with ``pack2_junction_only``; the
same gates and turns, the calls into ``ops/pack2.py``, the Gram launches
of one call, and a batch of 3 bitwise equal to pack2 off). Then the int8
conv at conv1_2 and conv3_1 on the cascade's maps and on half-normal
ones (``int8``: int32 sums bitwise equal to float64, the reference's
bound against the f32 conv on the half-normal maps, ms beside the f32
and bf16 convs). It checks
the outputs of each and one against another, and runs the CLI nine
times (``--fold``, ``--preset throughput --ring-conv``, and
``--checkpoints``/``--vgg-path`` against ``--weights`` on the bundle
that ``tools/make_bundle`` rebuilds from the per-level files among
them). Then the serving path at
1280×720, the stream CLI's default frame: the kernels at the stream's
shapes (``stream_kernels``), ``StreamStylizer`` strict and pipelined on
the bf16 fused, the f32 Newton–Schulz-kernel and the ``eigh`` routes
(``stream``), where a frame alone and in a batch of four part
(``stream_batch_gap``), ``BucketedStylizer`` on four buckets (``bucketed``) and
the stream CLI converting an mp4 on the bundle and on the per-level
files (``stream_cli``, where cv2 is installed). Last, decoder training, which reaches no hand-written
kernel: the relu5_1 decoder at batch 8 and crop 256 on a pool sampled on
the card (``train``: first-step gradients against float64, bf16 against
f32, remat and save-resume bitwise, ms per step, each conv shape's
forward and backward times and choice), the layerwise statistics and
solves (``train_layerwise``) and the training CLI with a resume, a
SIGTERM and the stylize CLI on its decoder (``train_cli``); ``train``
also saves five steps through the step-directory backend
(``TrainCheckpointer(fmt="orbax")``, ``keep=3``) and resumes from it as
from the npz one. Then the
mesh module on four shards of the card (and on every card where there
are more): data-parallel stylization of 8 images at 1024 px, f32 with
the Newton–Schulz kernel and bf16, each shard bitwise equal to
``stylize`` of its images, launches per shard, and with pack2 on a
batch that divides the mesh (each shard packs its own pairs) and on one
that does not (pack2 off, bitwise) (``mesh_dp``); one 2048×2048 image
split by height, the halo encoder, the combined covariances against
float64, each level against the unsharded cascade, and
``fold_transform``, ``ring_conv`` and pack2 on the one image each against
the call without, and pack2 in each scope, f32 and bf16, on the image and
a second one, an even batch that packs (``mesh_spatial``); the same image unsharded with and without
``ring_conv`` (``ring_2048``: ms in turns, peak bytes per level); the
data-parallel train step against
``train_step`` (``mesh_train``); and ``--data-parallel`` through both
CLIs, two processes of the stylize CLI writing the same bits
(``mesh_cli``).

Each phase prints one JSON line. The line before the last lists each
kernel with its launches in the main path's run and its times; the
last line is ``{"ok": true, "device": {...}}``. Any failed check
raises, so the script exits non-zero and prints no last line; so it
does without a CUDA device or outside a checkout.
"""

from __future__ import annotations

import contextlib
import dataclasses
import difflib
import io
import json
import re
import shutil
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from wct_tpu_torch.models import cascade, decoder, vgg
from wct_tpu_torch.ops import _build, conv_small, convs, gram, junction, pack2, reductions, sqrtm
from wct_tpu_torch.ops import eigh as eigh_ops
from wct_tpu_torch.ops import adain as adain_ops
from wct_tpu_torch.ops import style_swap as swap_ops
from wct_tpu_torch.ops import wct as wct_ops
from wct_tpu_torch.ops.convs import (
    compose_1x1_into_conv,
    conv2d_reflect_nchw,
    to_nchw,
    to_nhwc,
    upsample_nearest2_nchw,
)
from wct_tpu_torch.parallel import mesh as mesh_lib
from wct_tpu_torch.train import checkpoint, layerwise, trainer
from wct_tpu_torch.train import data as tdata
from wct_tpu_torch.utils import images
from wct_tpu_torch.tools import junction_stages
from wct_tpu_torch.tools.profile_sqrtm import sqrt_float64
from wct_tpu_torch.utils.device import card_name, cuda_ms
from wct_tpu_torch.utils.profiling import StageTimer, device_busy_share, shard_times, trace
from wct_tpu_torch.utils.serving import BucketedStylizer, bucket_shape, pad_to_bucket
from wct_tpu_torch.utils.stream import StreamStylizer

ROOT = Path(__file__).resolve().parent
SIZE = 512
N_CONTENT = 6
MICROBATCH = 4
ALPHA = 0.6
SEED = 0
DEV = "cuda"

# Data-sheet peaks (dense, no sparsity): fp32 outside the tensor cores,
# and device-memory bandwidth, of the H100 SXM and of the H100 PCIe card
# (NVIDIA's data sheets).
_PEAK_SXM = (67.0e12, 3.35e12)  # fp32 FLOP/s, bytes/s
_PEAK_PCIE = (51.2e12, 2.0e12)
# Dense bf16 and TF32 tensor-core rates of the same two parts.
_PEAK_BF16_SXM, _PEAK_BF16_PCIE = 989.0e12, 756.0e12
_PEAK_TF32_SXM, _PEAK_TF32_PCIE = 494.7e12, 378.0e12


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def peaks(name: str) -> tuple[float, float]:
    return _PEAK_PCIE if "PCIe" in name else _PEAK_SXM


def bf16_peak(name: str) -> float:
    return _PEAK_BF16_PCIE if "PCIe" in name else _PEAK_BF16_SXM


def tf32_peak(name: str) -> float:
    return _PEAK_TF32_PCIE if "PCIe" in name else _PEAK_TF32_SXM


def ns_flops(batch: int, c: int, iters: int) -> float:
    return batch * 2 * iters * 3 * c**3  # wct_tpu/ops/sqrtm.py:208


def ns_bound_ms(batch: int, c: int, iters: int, tf32: float, bw: float) -> tuple[float, str]:
    """Least time for one Newton–Schulz call: max(3 · ops / TF32 rate,
    bytes / bandwidth); the kernel's products run in 3×TF32."""
    nbytes = batch * c * c * 4 * 3  # read A, write both outputs
    return conv_bound_ms(3 * ns_flops(batch, c, iters), nbytes, tf32, bw)


KERNEL_WRAPPERS = {
    "ns_sqrtm": sqrtm.ns_sqrtm_cuda,
    "encoder_head": junction.encoder_head_cuda,
    "junction": junction.junction_cuda,
    "decoder_tail": junction.decoder_tail_cuda,
    "centered_gram": gram.centered_gram_cuda,
}
# The kernels with an f32 and a bf16 form, counted per form: "name" is the
# f32 form, "name_bf16" the bf16 one.
BY_DTYPE = ("encoder_head", "junction", "decoder_tail")
NO_LAUNCHES = {**{name: 0 for name in KERNEL_WRAPPERS}, **{f"{n}_bf16": 0 for n in BY_DTYPE},
               "conv3x3_small": 0, "conv3x3_small_nchw": 0}


def reset_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    for name in BY_DTYPE:
        KERNEL_WRAPPERS[name].launches_by_dtype = {"f32": 0, "bf16": 0}
    conv_small.conv3x3_small_cuda.launches = 0
    conv_small.conv3x3_small_cuda.launches_by_layout = {"nchw": 0, "nhwc": 0}


def read_counts() -> dict:
    """Launches per kernel; the junction kernels per operand type, the small
    conv per entry (NHWC, NCHW)."""
    by_layout = conv_small.conv3x3_small_cuda.launches_by_layout
    counts = {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
    for name in BY_DTYPE:
        by_dtype = KERNEL_WRAPPERS[name].launches_by_dtype
        counts[name], counts[f"{name}_bf16"] = by_dtype["f32"], by_dtype["bf16"]
    return {**counts, "conv3x3_small": by_layout["nhwc"], "conv3x3_small_nchw": by_layout["nchw"]}


def conv_bound_ms(ops: float, nbytes: float, flops: float, bw: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / flops * 1e3, nbytes / bw * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rel_max(a, b) -> float:
    """max |a − b| relative to the reference map's largest value."""
    return float((a - b).abs().max() / b.abs().max())


def rel_fro(a, b) -> float:
    """Largest per-matrix ‖a − b‖_F / ‖b‖_F over the batch."""
    return float(((a - b).flatten(1).norm(dim=1) / b.flatten(1).norm(dim=1)).max())


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA device")
    smi = card_name()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    return name


def phase_build():
    """Every kernel, and the junction with its stage stamps (phase
    junction_stages), one nvcc per source, all started together."""
    t0 = time.perf_counter()
    stamped = {}
    other = threading.Thread(target=lambda: stamped.update(
        _build.build_all(["junction"], junction_stages.DEFINES)))
    other.start()
    libs = _build.build_all()
    other.join()
    check(set(stamped) == {"junction"}, "the stamped junction build failed")
    secs = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in lib.with_name(lib.name + ".log").read_text().splitlines()
               if "registers" in ln or "spill" in ln]
        for name, lib in libs.items()
    }
    emit({"phase": "build", "seconds": secs, "libraries": [str(p.relative_to(ROOT)) for p in libs.values()],
          "ptxas": ptxas})


def level_covariances(params, images_nhwc, cfg):
    """The covariances the main path hands the kernel: each level's Grams
    (+eps·I) of a batch of images (one microbatch of content, or the
    style), from the trained encoder."""

    x = to_nchw(torch.as_tensor(images_nhwc, device=DEV))
    covs = {}
    with torch.no_grad():
        feats = vgg.encode_multi_nchw(params["encoder"], x, cfg.relu_targets)
        for level in cfg.relu_targets:
            cov, _ = wct_ops._gram_cn(feats[level].flatten(2))
            eye = torch.eye(cov.shape[-1], device=cov.device)
            covs[level] = (cov + wct_ops.DEFAULT_EPS * eye).contiguous()
    return covs


def residual(sq, a64) -> float:
    """Largest per-matrix ‖sq·sq − A‖_F / ‖A‖_F."""
    sq64 = sq.double()
    return rel_fro(sq64 @ sq64, a64)


def ns_float64(a, iters: int):
    """sqrt(A) by the same coupled iteration, every step in float64: what
    an f32-class kernel approaches however far `iters` steps leave the
    iteration from A^{1/2}."""
    c = a.shape[-1]
    a64 = a.double()
    eye = torch.eye(c, dtype=torch.float64, device=a.device)
    a64 = a64 + (sqrtm.DEFAULT_REG * a64.diagonal(dim1=-2, dim2=-1).sum(-1) / c)[:, None, None] * eye
    norm = a64.abs().sum(-1).amax(-1)[:, None, None]
    y, z = a64 / norm, eye.expand_as(a64)
    for _ in range(iters):
        t = 1.5 * eye - 0.5 * z @ y
        y, z = y @ t, t @ z
    return y * norm.sqrt()


# Newton–Schulz against float64, relative Frobenius: the reference's bar
# (wct_tpu/ops/sqrtm.py:53-58) against the same iteration in float64 at
# every case, and against the float64 square root where 14 steps converge
# (the SPD cases; on the trained level covariances both the kernel and the
# plain f32 loop stay 2e-3 from it: floor-level eigenvalues are still
# growing). Everywhere no more than twice the plain f32 loop's error
# against the float64 square root.
NS_F64_LIMIT, NS_F64_VS_PLAIN = 5e-5, 2.0


def phase_kernel(params, content, style, cfg, name, spd=True, phase="kernel"):
    """ns_sqrtm against its plain version and a float64 square root at the
    main path's shapes: each level's content covariances at B = 4 and the
    style's at B = 1, and (``spd``) random SPD matrices at B = 16."""

    flops, bw = peaks(name)
    tf32 = tf32_peak(name)
    iters, reg = sqrtm.DEFAULT_ITERS, sqrtm.DEFAULT_REG
    kernel = lambda a: sqrtm.ns_sqrtm_cuda(a, iters, reg)  # noqa: E731
    plain = lambda a: sqrtm._ns_plain(a, iters, reg)  # noqa: E731
    rows = []
    cases = [(lvl, a) for lvl, a in level_covariances(params, content[:MICROBATCH], cfg).items()]
    cases += [(f"{lvl}_style_b1", a)
              for lvl, a in level_covariances(params, style[None], cfg).items()]
    gen = torch.Generator().manual_seed(SEED)
    for c in (64, 128, 256, 512) if spd else ():  # random SPD at B=16, condition number 100
        q, _ = torch.linalg.qr(torch.randn(16, c, c, generator=gen, dtype=torch.float64))
        eig = torch.logspace(0, -2, c, dtype=torch.float64)
        cases.append((f"spd_b16_c{c}", ((q * eig) @ q.mT).float().to(DEV).contiguous()))
    for label, a in cases:
        b, c, _ = a.shape
        sq_k, isq_k = kernel(a)
        sq_p, isq_p = plain(a)
        torch.cuda.synchronize()
        err_sq, err_isq = rel_fro(sq_k, sq_p), rel_fro(isq_k, isq_p)
        eye = torch.eye(c, device=DEV)
        inv_err = float((sq_k @ isq_k - eye).flatten(1).norm(dim=1).max())
        max_abs = max(float((sq_k - sq_p).abs().max()), float((isq_k - isq_p).abs().max()))
        ref64, a64 = sqrt_float64(a, reg)
        iter64 = ns_float64(a, iters)
        again = kernel(a)
        alone = kernel(a[-1:].contiguous())
        n = 20 if c <= 256 else 10
        ms_k, ms_p = cuda_ms(lambda: kernel(a), n), cuda_ms(lambda: plain(a), n)
        bound, bound_by = ns_bound_ms(b, c, iters, tf32, bw)
        row = {"phase": phase, "kernel": "ns_sqrtm", "case": label, "B": b, "C": c,
               "rel_err_sqrt": err_sq, "rel_err_isqrt": err_isq, "max_abs_err": max_abs,
               "rel_err_vs_float64": rel_fro(sq_k.double(), ref64),
               "plain_rel_err_vs_float64": rel_fro(sq_p.double(), ref64),
               "rel_err_vs_float64_iteration": rel_fro(sq_k.double(), iter64),
               "plain_rel_err_vs_float64_iteration": rel_fro(sq_p.double(), iter64),
               "float64_iteration_vs_float64": rel_fro(iter64, ref64),
               "residual": residual(sq_k, a64), "plain_residual": residual(sq_p, a64),
               "bitwise_repeatable": all(torch.equal(x, y) for x, y in zip(again, (sq_k, isq_k))),
               "alone_equals_batch_bitwise": torch.equal(alone[0][0], sq_k[-1])
               and torch.equal(alone[1][0], isq_k[-1]),
               "sqrt_isqrt_minus_I_fro": inv_err, "ms": ms_k, "plain_ms": ms_p,
               "bound_ms": bound, "bound_by": bound_by,
               "ffma_floor_ms": ns_flops(b, c, iters) / flops * 1e3}
        del ref64, a64, iter64
        emit(row)
        check(err_sq <= 1e-4 and err_isq <= 1e-4,
              f"ns_sqrtm vs plain at {label}: rel err {err_sq:.2e}, {err_isq:.2e} > 1e-4")
        check(row["rel_err_vs_float64_iteration"] <= NS_F64_LIMIT,
              f"ns_sqrtm vs the float64 iteration at {label}: "
              f"{row['rel_err_vs_float64_iteration']:.2e} > {NS_F64_LIMIT}")
        check(row["rel_err_vs_float64"] <= NS_F64_VS_PLAIN * row["plain_rel_err_vs_float64"]
              and (not label.startswith("spd") or row["rel_err_vs_float64"] <= NS_F64_LIMIT),
              f"ns_sqrtm vs float64 at {label}: {row['rel_err_vs_float64']:.2e} (plain "
              f"{row['plain_rel_err_vs_float64']:.2e}; limits {NS_F64_LIMIT} on the SPD cases, "
              f"{NS_F64_VS_PLAIN}x plain)")
        check(row["bitwise_repeatable"], f"ns_sqrtm at {label}: two calls differ")
        check(row["alone_equals_batch_bitwise"], f"ns_sqrtm at {label}: alone differs from batch")
        rows.append(row)
    check_hgmma("ns_sqrtm", ("ns_product", "ns_cluster"), phase)
    # The kernel's line: one microbatch's five content levels.
    main_rows = [r for r in rows if r["case"] in cfg.relu_targets]
    return {
        "ms": sum(r["ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": sum(r["bound_ms"] for r in main_rows),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in main_rows) else "bytes",
        "max_abs_err": max(r["max_abs_err"] for r in main_rows),
    }


def drive(params, content, style, cfg):
    """One route through the user's entry points, the style once and the
    content in microbatches, with every launch count set to 0 just before
    and read just after: (cache, out, counts, wall seconds)."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = cascade.precompute_style(params["encoder"], style, cfg)
    out = cascade.stylize_microbatched(params, content, cache, ALPHA, cfg, microbatch=MICROBATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return cache, out, read_counts(), wall


def unfused_stages(params, batch, cache, cfg, runs=3) -> dict:
    """One microbatch's encode / transform / decode ms per level, unfused,
    teacher-forced on the running image as the cascade runs them."""
    stages = {}
    with torch.no_grad():
        x = to_nchw(batch).to(cfg.dtype)
        for level in cfg.relu_targets:
            enc = lambda: vgg.encode_multi_nchw(params["encoder"], x, (level,))[level]  # noqa: E731
            feats = enc()
            wct = lambda: cascade._transform_level(feats, level, cache[level], ALPHA, cfg)  # noqa: E731
            tr = wct()
            dec = lambda: decoder.decode_nchw(params["decoders"][level], tr, level)  # noqa: E731
            stages[level] = {"encode_ms": cuda_ms(enc, runs), "transform_ms": cuda_ms(wct, runs),
                             "decode_ms": cuda_ms(dec, runs)}
            x = dec()
    return stages


def phase_main(params, content, style, cfg):
    # The main path's run: style once, then two microbatches (the
    # second padded). Only this window's launches count.
    cache, out, counts, wall = drive(params, content, style, cfg)
    launches = counts["ns_sqrtm"]
    n_levels = len(cfg.relu_targets)
    n_chunks = -(-N_CONTENT // MICROBATCH)
    # Per level: one Newton–Schulz and one centred Gram for the style and
    # for each microbatch.
    check(counts == {**NO_LAUNCHES, "ns_sqrtm": n_levels * (1 + n_chunks),
                     "centered_gram": n_levels * (1 + n_chunks)},
          f"unfused main path launched {counts}")
    check(tuple(out.shape) == (N_CONTENT, SIZE, SIZE, 3), f"output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "non-finite output")
    check(float(out.min()) >= 0.0 and float(out.max()) <= 1.0, "output outside [0, 1]")

    out_a0 = cascade.stylize_microbatched(params, content[:MICROBATCH], cache, 0.0, cfg, MICROBATCH)
    out_a1 = cascade.stylize_microbatched(params, content[:MICROBATCH], cache, 1.0, cfg, MICROBATCH)
    a_diff = float((out_a0 - out_a1).abs().mean())
    check(a_diff > 1e-3, f"alpha=0 and alpha=1 outputs barely differ ({a_diff:.2e})")

    single = cascade.stylize_microbatched(params, content[:1], cache, ALPHA, cfg, MICROBATCH)
    check(torch.equal(single[0], out[0]), "output depends on the submitted batch size")

    plain_cfg = cascade.CascadeConfig(relu_targets=cfg.relu_targets, method="newton_schulz")
    plain_cache = cascade.precompute_style(params["encoder"], style, plain_cfg)
    out_plain = cascade.stylize_microbatched(params, content, plain_cache, ALPHA, plain_cfg,
                                             MICROBATCH)
    d = (out - out_plain).abs().flatten().double().cpu().numpy()
    q99, dmax = float(np.quantile(d, 0.99)), float(d.max())
    check(q99 <= 5e-3, f"kernel cascade vs plain cascade q99 {q99:.2e} > 5e-3")

    batch = torch.as_tensor(content[:MICROBATCH], device=DEV)
    runs = 3
    ms_frame = cuda_ms(lambda: cascade.stylize(params, batch, cache, ALPHA, cfg), runs) / MICROBATCH
    ms_frame_plain = cuda_ms(
        lambda: cascade.stylize(params, batch, plain_cache, ALPHA, plain_cfg), runs
    ) / MICROBATCH
    ms_style = cuda_ms(lambda: cascade.precompute_style(params["encoder"], style, cfg), runs)

    stages = unfused_stages(params, batch, cache, cfg, runs)
    interp = interp_enqueue(params, batch, [cache, cascade.precompute_style(
        params["encoder"], np.ascontiguousarray(style[::-1]), cfg)], cfg)
    check(interp["enqueue_ms"] < 0.5 * interp["call_ms"],
          f"stylize_interp with new weights waited for the card: {interp}")
    emit({"phase": "main", "config": "CascadeConfig(method='newton_schulz_pallas')",
          "size": SIZE, "n_images": N_CONTENT, "microbatch": MICROBATCH, "alpha": ALPHA,
          "launches": counts, "first_run_wall_s": wall,
          "alpha0_vs_alpha1_mean_abs": a_diff, "batch1_vs_batch6_bitwise_equal": True,
          "vs_plain_q99": q99, "vs_plain_max": dmax, "ms_per_frame_b4": ms_frame,
          "ms_per_frame_b4_plain_ns": ms_frame_plain, "precompute_style_ms": ms_style,
          "stages_b4_ms": stages, "interp_new_weights": interp,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    return launches, out


def interp_enqueue(params, batch, caches, cfg) -> dict:
    """Does ``stylize_interp`` with new weights return before the card is
    done? A ``stylize`` is queued first, then the blend of two styles with
    weights it has not seen; a copy of the weights from pageable host
    memory would wait for the queued call, as α once did (PERF.md). The
    host's return against the end of both, best of three."""
    calls = []
    for i in range(3):
        weights = [0.3 + 0.1 * i, 0.7 - 0.1 * i]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cascade.stylize(params, batch, caches[0], ALPHA, cfg)
        cascade.stylize_interp(params, batch, caches, weights, ALPHA, cfg)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        calls.append((t1 - t0, time.perf_counter() - t0))
    enqueue, call = min(calls)
    return {"enqueue_ms": enqueue * 1e3, "call_ms": call * 1e3}


# Kernel against plain: f32-class sums of up to 576 terms taken in another
# order (the 64->64 convs in 3xTF32), through up to four convs with conv0's
# O(255) weights in the third. Limit on max |Δ| relative to the map's largest
# value (measured ≤ 5.2e-5, most of it plain's own error: at the relu5_1
# junction plain is 3.5e-5 from a float64 evaluation, the kernel 5e-6; both
# are printed per case).
JUNCTION_LIMIT = 1e-4
# The bf16 forms: every conv sums exact products in f32 and rounds once,
# kernel and plain alike. One conv (the tail) against plain: ≥ 99 % of the
# elements bitwise equal, all within one bf16 ulp. A chain (head, junction)
# carries a flipped rounding forward: one flip upstream of conv0's O(255)
# weights moves some 20 outputs beyond an ulp and one by up to about 1 % of
# the map's max, and cuDNN's plain chain is itself up to 0.7 % of its
# outputs beyond one ulp of a float64 evaluation of the same rule and 1.7 %
# of the max away from it. So the chains are held to that evaluation, at
# bars a few such events cannot break and a systematic error would: ≥ 99 %
# bitwise, ≥ 99.5 % within one ulp (q99.5 of |Δ|), max |Δ| ≤ 2e-2 of max
# |ref|; and to plain by the max bound.
BF16_BITWISE, BF16_WITHIN, BF16_CHAIN_MAX = 0.99, 0.995, 2e-2
# Fused cascade against unfused cascade of the same run: the limits the CPU
# tests hold the two routes to (five levels of whitening amplify the
# kernels' rounding differences ≈100×).
FUSED_Q99_LIMIT, FUSED_MAX_LIMIT = 5e-3, 3e-2


def bf16_agreement(got, ref) -> dict:
    """Shares of the elements bitwise equal and within one bf16 ulp
    (|Δ| ≤ 2⁻⁷·|ref| + 1e-5·max|ref|), and max |Δ| relative to max |ref|."""
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    excess = d - (2.0**-7 * ref.abs() + 1e-5 * ref.abs().max())
    return {"bitwise": float((d == 0).float().mean()), "within_ulp": float((excess <= 0).float().mean()),
            "rel_max": float(d.max() / ref.abs().max())}


def head_weights(params):
    enc = params["encoder"]
    we1, be1 = junction.fold_conv0(enc["conv0"]["w"], enc["conv0"]["b"],
                                   enc["conv1_1"]["w"], enc["conv1_1"]["b"])
    return we1, be1, enc["conv1_2"]["w"], enc["conv1_2"]["b"]


def main_path_inputs(params, content, cache, cfg):
    """What one microbatch hands each junction kernel on the fused main
    path: the content batch (head), the decoder states ``d`` of the
    trained relu5_1/4_1/3_1 levels (junction), and the relu1_1 features
    with their folded per-image weights (tail). Teacher-forced through
    the unfused cascade."""
    ds = {}
    with torch.no_grad():
        x = to_nchw(torch.as_tensor(content[:MICROBATCH], device=DEV))
        img = x
        for level in cfg.relu_targets[:-1]:
            feats = vgg.encode_multi_nchw(params["encoder"], x, (level,))[level]
            tr = cascade._transform_level(feats, level, cache[level], ALPHA, cfg)
            dec_p = params["decoders"][level]
            if level != "relu2_1":
                ds[level] = (decoder.decode_partial_nchw(dec_p, tr, level).contiguous(),
                             decoder.tail_weights(dec_p, level))
            x = decoder.decode_nchw(dec_p, tr, level)
        f = vgg.encode_multi_nchw(params["encoder"], x, ("relu1_1",))["relu1_1"].contiguous()
        m, bias = wct_ops.wct_transform_cn(f.flatten(2), cache["relu1_1"].stats, ALPHA,
                                           method=cfg.method)
        conv = params["decoders"]["relu1_1"]["dec_conv1_1"]
        wf, bf = decoder.fold_affine_into_conv(m, bias, conv["w"], conv["b"])
    return img.contiguous(), ds, (f, wf, bf)


def unfused_bf16_chain(hw, tw=None):
    """The unfused bf16 head or junction through the cascade's stock convs
    (cuDNN bf16 on the card): a time reference for the kernels, which no
    single library call matches."""
    we1, be1, w12, b12 = hw

    def head(x):
        e1 = torch.relu(conv2d_reflect_nchw(x, we1, be1))
        return F.max_pool2d(torch.relu(conv2d_reflect_nchw(e1, w12, b12)), 2)

    if tw is None:
        return head
    wd1, bd1, wd2, bd2 = tw
    return lambda d: head(conv2d_reflect_nchw(
        torch.relu(conv2d_reflect_nchw(upsample_nearest2_nchw(d), wd1, bd1)), wd2, bd2))


def phase_junction_kernels(params, content, cache, cfg, name, dtypes=(torch.float32, torch.bfloat16),
                           main_case="main_b4_512", edge_cases=True, phase="kernel", main=True):
    """encoder_head, junction and decoder_tail, each form in ``dtypes``
    against its plain version, at the main path's shapes (``content``'s
    first microbatch; ``main=False`` marks them as another route's and
    returns no line) and, with ``edge_cases``, at awkward ones. Every case
    also holds the kernel on the batch's first image alone to the batch's
    first image, bitwise: an image's result must not depend on its batch.
    The 64→64
    convs run on the tensor cores, f32 in 3×TF32, bf16 in one pass: the
    bound is the passes over all the FLOP at the type's rate (or the bytes),
    with the fp32 FFMA floor beside it. The bf16 cases take the f32 main
    path's tensors rounded to bf16."""
    flops, bw = peaks(name)
    rates = {torch.float32: (3, tf32_peak(name)), torch.bfloat16: (1, bf16_peak(name))}
    hw = head_weights(params)
    img, ds, (f, wf, bf) = main_path_inputs(params, content, cache, cfg)
    gen = torch.Generator().manual_seed(SEED + 2)
    rand = lambda *shape: torch.rand(*shape, generator=gen).to(DEV)  # noqa: E731
    rows = []

    def run(kernel_name, case, kernel, plain, ops, nbytes, shape, main, alone, library=None,
            plain64=None, chain=True, unfused=None):
        got, ref = kernel(), plain()
        first = alone()
        torch.cuda.synchronize()
        bf16 = got.dtype == torch.bfloat16
        label = f"{kernel_name}_bf16" if bf16 else kernel_name
        check(bool(torch.isfinite(got.float()).all()) and float(ref.float().abs().max()) > 0,
              f"{label} {case}: degenerate output")
        err = rel_max(got.float(), ref.float())
        again = kernel()
        row = {"phase": phase, "kernel": label, "case": case, "shape": list(shape),
               "main_path": main, "rel_max_err": err,
               "max_abs_err": float((got.float() - ref.float()).abs().max()),
               "bitwise_repeatable": bool(torch.equal(got, again)),
               "alone_equals_batch_bitwise": bool(torch.equal(first, got[:1]))}
        del first
        if bf16:
            row["vs_plain"] = bf16_agreement(got, ref)
        if plain64 is not None:  # both against a float64 evaluation of the same chain
            ref64 = plain64()
            if bf16:
                row["vs_float64"] = bf16_agreement(got, ref64)
                row["plain_vs_float64"] = bf16_agreement(ref, ref64)
            else:
                row["rel_max_err_vs_float64"] = rel_max(got.double(), ref64)
                row["plain_rel_max_err_vs_float64"] = rel_max(ref.double(), ref64)
            del ref64
        passes, rate = rates[got.dtype]
        bound, by = conv_bound_ms(passes * ops, nbytes * got.element_size(), rate, bw)
        row["ffma_floor_ms"] = ops / flops * 1e3
        n = 10 if main else 3  # the main path's shapes are the ones PERF.md keeps
        row.update(ms=cuda_ms(kernel, n), plain_ms=cuda_ms(plain, n // 2 + 1), bound_ms=bound,
                   bound_by=by, library_ms=cuda_ms(library, 5) if library else None)
        if unfused is not None:
            row["unfused_chain_ms"] = cuda_ms(unfused, 5)
        emit(row)
        if not bf16:
            check(err <= JUNCTION_LIMIT, f"{label} vs plain at {case}: {err:.2e} > {JUNCTION_LIMIT}")
        elif chain:
            v = row["vs_float64"]
            check(v["bitwise"] >= BF16_BITWISE and v["within_ulp"] >= BF16_WITHIN
                  and v["rel_max"] <= BF16_CHAIN_MAX and row["vs_plain"]["rel_max"] <= BF16_CHAIN_MAX,
                  f"{label} at {case}: {row['vs_float64']} against float64 (plain "
                  f"{row['plain_vs_float64']}), {row['vs_plain']} against plain")
        else:
            v = row["vs_plain"]
            check(v["bitwise"] >= BF16_BITWISE and v["within_ulp"] == 1.0,
                  f"{label} vs plain at {case}: {v}")
        check(row["bitwise_repeatable"], f"{label} at {case}: two calls differ")
        check(row["alone_equals_batch_bitwise"],
              f"{label} at {case}: the first image alone differs from it in the batch")
        rows.append(row)

    def head_case(case, x, main=False):
        b, _, h, w = x.shape
        unfused = (lambda: unfused_bf16_chain(hw)(x)) if main and x.dtype == torch.bfloat16 else None
        run("encoder_head", case, lambda: junction.encoder_head_cuda(x, *hw),
            lambda: junction._encoder_head_plain(x, *hw),
            b * 2 * h * w * 9 * (3 * 64 + 64 * 64), b * h * w * (3 + 16), x.shape, main,
            lambda: junction.encoder_head_cuda(x[:1].contiguous(), *hw),
            plain64=(lambda: junction._encoder_head_plain(x, *hw, acc=torch.float64))
            if x.dtype == torch.bfloat16 else None, unfused=unfused)

    def junction_case(case, d, tw, deep, clip, main=False):
        b, _, h, w = d.shape
        args = (d, *tw, *hw, deep, clip)
        if d.dtype == torch.bfloat16:
            plain64 = lambda: junction._junction_plain(*args, acc=torch.float64)  # noqa: E731
        else:
            args64 = [t.double() if torch.is_tensor(t) else t for t in args]
            plain64 = lambda: junction._junction_plain(*args64)  # noqa: E731
        px = 4 * h * w
        ops = b * 2 * px * 9 * (64 * 64 + 64 * 3 + 3 * 64 + (64 * 64 if deep else 0))
        nbytes = b * 64 * (h * w + (h * w if deep else px))
        unfused = (lambda: unfused_bf16_chain(hw, tw)(d)) if main and d.dtype == torch.bfloat16 else None
        run("junction", case, lambda: junction.junction_cuda(*args),
            lambda: junction._junction_plain(*args), ops, nbytes, d.shape, main,
            lambda: junction.junction_cuda(d[:1].contiguous(), *args[1:]),
            plain64=plain64, unfused=unfused)

    def tail_case(case, x, w, b, clip, main=False):
        bsz, c, h, wd = x.shape
        library = None
        if main:  # the one PyTorch call that computes it: a grouped conv on the padded map
            xp = F.pad(x, (1, 1, 1, 1), mode="reflect").reshape(1, bsz * c, h + 2, wd + 2)
            wg = w.reshape(bsz * 3, c, 3, 3).to(x.dtype).contiguous()
            bg = b.reshape(-1).to(x.dtype).contiguous()
            library = lambda: F.conv2d(xp, wg, bg, groups=bsz)  # noqa: E731
        run("decoder_tail", case, lambda: junction.decoder_tail_cuda(x, w, b, clip),
            lambda: junction._decoder_tail_plain(x, w, b, clip),
            bsz * 2 * h * wd * 9 * 64 * 3, bsz * h * wd * (64 + 3), x.shape, main,
            lambda: junction.decoder_tail_cuda(x[:1].contiguous(), w[:1].contiguous(),
                                               b[:1].contiguous(), clip),
            library, chain=False)

    bf16 = torch.bfloat16
    for dtype in dtypes:
        head_case(main_case, img.to(dtype), main=main)
        for level, (d, tw) in ds.items():
            case = level if main_case == "main_b4_512" else f"{level}_{main_case}"
            junction_case(case, d.to(dtype), tw, True, False, main=main)
        tail_case(main_case, f.to(dtype), wf, bf, False, main=main)
    if edge_cases:
        d3, tw = ds["relu3_1"]
        for dtype in (torch.float32, bf16):
            # The same main-path map through the clip, which the cascade's last
            # junction of a clipped run takes, and the shallow variant at the main
            # path's size, though the cascade never calls it.
            junction_case("relu3_1_clip", d3.to(dtype), tw, True, True)
            junction_case("relu3_1_shallow", d3.to(dtype), tw, False, False)
        for b, h, w in ((1, 16, 16), (2, 48, 32), (3, 64, 16), (1, 512, 512)):
            label = f"b{b}_{h}x{w}"
            x, dmap, fmap = rand(b, 3, h, w), rand(b, 64, h // 2, w // 2) * 20, rand(b, 64, h, w)
            wt, bt = (rand(b, 3, 64, 3, 3) - 0.5) * 0.2, rand(b, 3)
            for dtype in (torch.float32, bf16):
                head_case(label, x.to(dtype))
                for deep in (True, False):
                    for clip in (False, True):  # ×20: the rgb stage leaves [0, 1], so the clip acts
                        junction_case(f"{label}_{'deep' if deep else 'shallow'}{'_clip' if clip else ''}",
                                      dmap.to(dtype), tw, deep, clip)
                for clip in (False, True):
                    tail_case(f"{label}{'_clip' if clip else ''}", fmap.to(dtype), wt, bt, clip)

    def line(kernel_name):
        mine = [r for r in rows if r["kernel"] == kernel_name]
        main_rows = [r for r in mine if r["main_path"]]
        lib = [r["library_ms"] for r in main_rows]
        return {
            "max_abs_err": max(r["max_abs_err"] for r in main_rows),
            "rel_max_err": max(r["rel_max_err"] for r in mine),
            "ms": sum(r["ms"] for r in main_rows),
            "plain_ms": sum(r["plain_ms"] for r in main_rows),
            "bound_ms": sum(r["bound_ms"] for r in main_rows),
            "bound_by": main_rows[0]["bound_by"],
            "library_ms": None if None in lib else sum(lib),
        }

    if main:  # conv1_2 of the head runs on wgmma in both forms
        check_hgmma("encoder_head", ("encoder_head",), phase)
    return {k: line(k) for n in BY_DTYPE for k in (n, f"{n}_bf16")
            if any(r["kernel"] == k and r["main_path"] for r in rows)}


def sass_counts(lib: Path, mnemonic: str) -> dict:
    """Per kernel function of a built library, how many SASS instructions
    start with ``mnemonic`` (``cuobjdump -sass`` from the toolkit)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        out[block.split("\n", 1)[0].strip()] = len(re.findall(rf"\b{mnemonic}\b", block))
    return out


def check_hgmma(lib: str, functions: tuple[str, ...], phase: str) -> None:
    """Fail unless every kernel function of ``csrc/<lib>.cu`` whose name
    holds one of ``functions`` (its wgmma routes) has HGMMA in its SASS."""
    hgmma = sass_counts(_build.library_path(lib), "HGMMA")
    mine = {f: n for f, n in hgmma.items() if any(k in f for k in functions)}
    emit({"phase": phase, "kernel": lib, "sass_hgmma_per_function": mine})
    check(len(mine) > 0 and all(n > 0 for n in mine.values()),
          f"{lib}'s SASS lacks HGMMA in a wgmma function: {mine}")


def phase_junction_stages(params, content, cache, cfg):
    """Where a junction tile's time goes, per stage, in both forms, on the
    main path's relu4_1 decoder state ``[4, 64, 256, 256]`` (trained
    weights), from the build with stage stamps
    (``tools/junction_stages.py``): median µs per tile of the d-tile load,
    conv m, rgb, e1, conv1_2 + pool, the halo fix and the weight waits.
    Beside each: ms per launch of the normal build, the shared-memory
    plan, and the distance from a float64 evaluation. Fails unless both
    forms' SASS holds HGMMA."""
    _, ds, _ = main_path_inputs(params, content, cache, cfg)
    d, tw = ds["relu4_1"]
    weights = [*tw, *head_weights(params)]
    forms = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = d.to(dtype).contiguous()
        split = junction_stages.stage_split(x, weights)

        def launch():
            return junction._junction_launch("junction", x, *weights, True, False)

        split["ms"] = cuda_ms(launch, 10)
        split["vs_float64"] = junction_stages.vs_float64(launch(), x, weights, True, False)
        smem, blocks = junction.kernel_plan("junction", dtype)
        split["plan"] = {"smem_bytes": smem, "blocks_per_sm": blocks}
        forms["f32" if dtype == torch.float32 else "bf16"] = split
    hgmma = sass_counts(_build.library_path("junction"), "HGMMA")
    emit({"phase": "junction_stages", "card": card_name(), "level": "relu4_1",
          "shape": list(d.shape), "forms": forms, "sass_hgmma_per_function": hgmma})
    check(len(hgmma) == 2 and all(n > 0 for n in hgmma.values()),
          f"the junction's SASS lacks HGMMA in a form: {hgmma}")


def fused_stages(params, batch, cache, cfg) -> dict:
    """One microbatch's stages as a fused cascade runs them, encode / WCT /
    decode ms per level, in the configuration's operand type (a fused
    decode stage holds the next level's head)."""
    stages = {}
    enc = params["encoder"]
    head_args = tuple(enc[n][k] for n in ("conv0", "conv1_1", "conv1_2") for k in ("w", "b"))
    with torch.no_grad():
        x, kind = to_nchw(batch).to(cfg.dtype), "img"
        for level in cfg.relu_targets:
            dec_p = params["decoders"][level]
            if level == "relu1_1":
                encode = lambda: vgg.encode_multi_nchw(enc, x, (level,))[level]  # noqa: E731
            elif kind == "img":
                encode = lambda: vgg.encode_from_pool1_nchw(  # noqa: E731
                    enc, junction.encoder_head_nchw(x, *head_args), level)
            else:
                encode = lambda: vgg.encode_from_pool1_nchw(enc, x, level)  # noqa: E731
            feats = encode()
            if level == "relu1_1":
                conv = dec_p["dec_conv1_1"]

                def wct():
                    m, bias = cascade._level_affine(feats, level, cache[level], ALPHA, cfg)
                    return decoder.fold_affine_into_conv(m, bias, conv["w"], conv["b"])

                wf, bf = wct()
                dec = lambda: junction.decoder_tail_nchw(feats, wf, bf)  # noqa: E731
                kind = "img"
            else:
                wct = lambda: cascade._transform_level(feats, level, cache[level], ALPHA, cfg)  # noqa: E731
                tr = wct()
                if level == "relu2_1":
                    dec = lambda: decoder.decode_nchw(dec_p, tr, level)  # noqa: E731
                    kind = "img"
                else:
                    dec = lambda: junction.junction_nchw(  # noqa: E731
                        decoder.decode_partial_nchw(dec_p, tr, level),
                        *decoder.tail_weights(dec_p, level), *head_args)
                    kind = "pooled"
            stages[level] = {"encode_ms": cuda_ms(encode, 3), "wct_ms": cuda_ms(wct, 3),
                             "decode_ms": cuda_ms(dec, 3)}
            x = dec()
    return stages


def phase_main_fused(params, content, style, cfg, out_unfused, cache_unfused, cfg_unfused):
    """The fuse_junction cascade through the same entry points."""
    cache, out, counts, wall = drive(params, content, style, cfg)
    n_chunks = -(-N_CONTENT // MICROBATCH)
    expected = {**NO_LAUNCHES, "ns_sqrtm": 5 * (1 + n_chunks), "centered_gram": 5 * (1 + n_chunks),
                "encoder_head": n_chunks, "junction": 3 * n_chunks, "decoder_tail": n_chunks}
    check(counts == expected, f"fused main path launched {counts}, expected {expected}")
    check(tuple(out.shape) == (N_CONTENT, SIZE, SIZE, 3), f"output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "non-finite output")
    check(float(out.min()) >= 0.0 and float(out.max()) <= 1.0, "output outside [0, 1]")

    out_a0 = cascade.stylize_microbatched(params, content[:MICROBATCH], cache, 0.0, cfg, MICROBATCH)
    out_a1 = cascade.stylize_microbatched(params, content[:MICROBATCH], cache, 1.0, cfg, MICROBATCH)
    a_diff = float((out_a0 - out_a1).abs().mean())
    check(a_diff > 1e-3, f"alpha=0 and alpha=1 outputs barely differ ({a_diff:.2e})")
    a0_err = float((out_a0 - torch.as_tensor(content[:MICROBATCH], device=DEV)).abs().mean())

    single = cascade.stylize_microbatched(params, content[:1], cache, ALPHA, cfg, MICROBATCH)
    check(torch.equal(single[0], out[0]), "fused output depends on the submitted batch size")

    d = (out - out_unfused).abs().flatten().double().cpu().numpy()
    q99, dmax = float(np.quantile(d, 0.99)), float(d.max())
    check(q99 <= FUSED_Q99_LIMIT and dmax <= FUSED_MAX_LIMIT,
          f"fused vs unfused cascade q99 {q99:.2e}, max {dmax:.2e} > {FUSED_Q99_LIMIT}, {FUSED_MAX_LIMIT}")

    batch = torch.as_tensor(content[:MICROBATCH], device=DEV)
    runs = 5
    fused = lambda: cascade.stylize(params, batch, cache, ALPHA, cfg)  # noqa: E731
    unfused = lambda: cascade.stylize(params, batch, cache_unfused, ALPHA, cfg_unfused)  # noqa: E731
    # In turns on one card: unfused, fused, fused, unfused.
    t = [cuda_ms(fn, runs) / MICROBATCH for fn in (unfused, fused, fused, unfused)]

    stages = fused_stages(params, batch, cache, cfg)
    emit({"phase": "main_fused",
          "config": "CascadeConfig(method='newton_schulz_pallas', fuse_junction=True)",
          "size": SIZE, "n_images": N_CONTENT, "microbatch": MICROBATCH, "alpha": ALPHA,
          "launches": counts, "first_run_wall_s": wall, "alpha0_vs_alpha1_mean_abs": a_diff,
          "alpha0_vs_content_mean_abs": a0_err, "batch1_vs_batch6_bitwise_equal": True,
          "vs_unfused_q99": q99, "vs_unfused_max": dmax,
          "ms_per_frame_b4": (t[1] + t[2]) / 2, "ms_per_frame_b4_unfused": (t[0] + t[3]) / 2,
          "ms_per_frame_b4_turns_unfused_fused_fused_unfused": t,
          "stages_b4_ms": stages, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    return counts


# The bf16 throughput configuration: the JAX package's throughput preset
# without its TPU-lane rewrite pack2_junction.
THROUGHPUT = dict(compute_dtype="bfloat16", method="newton_schulz_fast", compose_conv0=True)
# Small conv, kernel against plain: both sum exact bf16 products in f32 and
# round once, so they differ by at most one bf16 ulp (≤ 2⁻⁷·|ref|) where the
# order of the sum moves a value across a rounding point.
# Against the cascade's stock conv, which rounds the sum and then adds the
# bf16 bias: |Δ| ≤ 2⁻⁷·(|ref| + max|bias|).
# Centred Gram: relative Frobenius ≤ 1e-6 against a float64 evaluation, at
# every shape. Against the plain version only ≤ 1e-4: ReLU features are
# mostly zeros, every zero gives the same centred product, and the plain
# version's f32 sum of thousands of equal terms rounds the same way at each
# step (its own error against float64 is printed beside the kernel's).
GRAM_LIMIT, GRAM_F64_LIMIT = 1e-4, 1e-6
# Throughput cascade against the f32 cascade: the reference's gates
# (tests/test_trained_fidelity.py): one level q99 < 0.05, composed median < 0.2.
LEVEL_Q99_LIMIT, COMPOSED_MEDIAN_LIMIT = 0.05, 0.2


def ulp_excess(got, ref, extra=0.0) -> float:
    """max over elements of |got − ref| − (2⁻⁷·(|ref| + extra) + 1e-5·max|ref|);
    ≤ 0 means within one bf16 ulp everywhere."""
    got, ref = got.float(), ref.float()
    limit = 2.0**-7 * (ref.abs() + extra) + 1e-5 * ref.abs().max()
    return float(((got - ref).abs() - limit).max())


def throughput_path_tensors(params, content, cache, cfg):
    """What one microbatch of the bf16 cascade really produces at 512 px,
    teacher-forced level by level: each level's features (the Gram's
    inputs), and the full-resolution 64-channel tier around the relu2_1
    decoder and the relu1_1 level (the small conv's inputs and the
    outputs the cascade's own convs gave for them)."""
    enc = params["encoder"]
    t = {"feats": {}}
    with torch.no_grad():
        x = to_nchw(torch.as_tensor(content[:MICROBATCH], device=DEV)).to(cfg.dtype)
        t["img0"] = x
        t["head_w"] = compose_1x1_into_conv(enc["conv0"]["w"], enc["conv0"]["b"],
                                            enc["conv1_1"]["w"], enc["conv1_1"]["b"])
        t["e1_0"] = torch.relu(conv2d_reflect_nchw(x, *t["head_w"]))
        for level in cfg.relu_targets:
            feats = vgg.encode_multi_nchw(enc, x, (level,), compose_pre=True)[level]
            t["feats"][level] = feats
            tr = cascade._transform_level(feats, level, cache[level], ALPHA, cfg)
            dec_p = params["decoders"][level]
            if level == "relu2_1":
                d = torch.relu(conv2d_reflect_nchw(tr, dec_p["dec_conv2_1"]["w"], dec_p["dec_conv2_1"]["b"]))
                t["dec2_u"] = upsample_nearest2_nchw(d)
                t["dec2_m"] = torch.relu(conv2d_reflect_nchw(
                    t["dec2_u"], dec_p["dec_conv1_2"]["w"], dec_p["dec_conv1_2"]["b"]))
            if level == "relu1_1":
                t["img1"], t["f1"], t["tr1"] = x, feats, tr
            x = decoder.decode_nchw(dec_p, tr, level)
        t["out1"] = x
    return t


def phase_conv_small_kernels(params, t, name):
    """conv3x3_small, both entries, against its plain version: the
    trained 3→64, 64→64 and 64→3 convs on the tensors the throughput
    cascade hands them, at B = 4 and B = 1, on a 1280×720 frame (the
    stream's; an image in [0, 1] or a ReLU map), and awkward shapes."""
    bw = peaks(name)[1]
    tensor_rate = bf16_peak(name)
    enc, dec2 = params["encoder"], params["decoders"]["relu2_1"]
    pair = lambda p: (p["w"], p["b"])  # noqa: E731
    cases = [
        ("head_3to64_relu", t["img0"], t["head_w"], True),
        ("conv1_2_64to64_relu", t["e1_0"], pair(enc["conv1_2"]), True),
        ("dec_relu2_1_64to64_relu", t["dec2_u"], pair(dec2["dec_conv1_2"]), True),
        ("dec_relu2_1_64to3", t["dec2_m"], pair(dec2["dec_conv1_1"]), False),
    ]
    gen = torch.Generator().manual_seed(SEED + 3)
    rows = []

    def run(case, x, w, b, relu, main):
        bsz, cin, h, wd = x.shape
        cout = w.shape[0]
        x_nhwc = to_nhwc(x)
        ref = conv_small._conv3x3_small_plain(x, w, b, relu)
        got = conv_small.conv3x3_reflect_small_nchw(x, w, b, relu)
        got_nhwc = conv_small.conv3x3_reflect_small(x_nhwc, w, b, relu)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()) and float(ref.float().abs().max()) > 0,
              f"conv3x3_small {case}: degenerate output")
        excess = ulp_excess(got, ref)
        same = bool(torch.equal(to_nchw(got_nhwc), got))
        again = bool(torch.equal(got, conv_small.conv3x3_reflect_small_nchw(x, w, b, relu)))
        ops = bsz * 2 * h * wd * 9 * cin * cout
        nbytes = bsz * h * wd * (cin + cout) * 2 + w.numel() * 2 + cout * 4
        bound, by = conv_bound_ms(ops, nbytes, tensor_rate, bw)
        n = 10 if main else 3
        xp = F.pad(x, (1, 1, 1, 1), mode="reflect")
        w16, b16 = w.to(torch.bfloat16), b.to(torch.bfloat16)
        library = (lambda: torch.relu(F.conv2d(xp, w16, b16))) if relu else (lambda: F.conv2d(xp, w16, b16))
        row = {"phase": "kernel", "kernel": "conv3x3_small", "case": case,
               "shape_nchw": [bsz, cin, h, wd], "c_out": cout, "relu": relu, "main_path": main,
               "ulp_excess": excess, "max_abs_err": float((got.float() - ref.float()).abs().max()),
               "nhwc_equals_nchw_bitwise": same, "bitwise_repeatable": again,
               "ms_nchw": cuda_ms(lambda: conv_small.conv3x3_reflect_small_nchw(x, w, b, relu), n),
               "ms_nhwc": cuda_ms(lambda: conv_small.conv3x3_reflect_small(x_nhwc, w, b, relu), n),
               "plain_ms": cuda_ms(lambda: conv_small._conv3x3_small_plain(x, w, b, relu), n // 2 + 1),
               "library_ms": cuda_ms(library, n // 2 + 1),
               "bound_ms": bound, "bound_by": by, "ffma_floor_ms": ops / peaks(name)[0] * 1e3}
        emit(row)
        check(excess <= 0, f"conv3x3_small vs plain at {case}: {excess:.2e} past one bf16 ulp")
        check(same, f"conv3x3_small at {case}: NHWC and NCHW entries differ")
        check(again, f"conv3x3_small at {case}: two calls differ")
        rows.append(row)

    for case, x, (w, b), relu in cases:
        run(f"{case}_b4_512", x.contiguous(), w, b, relu, True)
    for case, x, (w, b), relu in cases:
        run(f"{case}_b1_512", x[:1].contiguous(), w, b, relu, False)
    for case, x, (w, b), relu in cases:
        shape = (1, x.shape[1], 720, 1280)
        frame = torch.rand(shape, generator=gen) if x.shape[1] == 3 else torch.randn(shape, generator=gen).relu()
        run(f"{case}_b1_720x1280", frame.to(DEV).to(torch.bfloat16), w, b, relu, False)
    for bsz, h, wd in ((1, 8, 8), (2, 24, 40), (3, 16, 264)):
        for case, _, (w, b), relu in cases:
            x = torch.randn(bsz, w.shape[1], h, wd, generator=gen).to(DEV).to(torch.bfloat16)
            run(f"{case}_b{bsz}_{h}x{wd}", x, w, b, relu, False)

    check_hgmma("conv3x3_small", ("conv3x3_small_wgmma",), "kernel")

    def line(key):
        main_rows = [r for r in rows if r["main_path"]]
        return {"max_abs_err": max(r["max_abs_err"] for r in main_rows),
                "ms": sum(r[key] for r in main_rows),
                "plain_ms": sum(r["plain_ms"] for r in main_rows),
                "bound_ms": sum(r["bound_ms"] for r in main_rows),
                "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in main_rows) else "operations",
                "library_ms": sum(r["library_ms"] for r in main_rows)}

    return {"conv3x3_small": line("ms_nhwc"), "conv3x3_small_nchw": line("ms_nchw")}


def library_gram(x):
    """One PyTorch call for the same function, the yardstick of
    ``library_ms``: ``baddbmm(−N·μμᵀ, x, xᵀ)`` in full f32 (TF32 off) on
    the f32 upcast, after its mean; no route calls it."""
    x32 = x.float()
    n = x32.shape[-1]
    mu = x32.mean(-1)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.baddbmm(mu[:, :, None] * mu[:, None, :], x32, x32.mT, beta=-n), mu
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def phase_gram_kernel(t, name, edge_cases=True, extra=(), phase="kernel"):
    """centered_gram against its plain version: the five levels' bf16
    features of the throughput cascade at B = 4 and, with ``edge_cases``,
    at B = 1, their f32 upcast at relu1_1, the grouped shapes four groups
    give at relu1_1 and relu2_1 (``[16, 16, 262,144]``, ``[16, 32,
    65,536]``), and N = 7, 132 and 1000; then the ``extra`` (case, x)
    pairs."""
    flops, bw = peaks(name)
    tf32 = tf32_peak(name)
    gen = torch.Generator().manual_seed(SEED + 4)
    rows = []

    def run(case, x, main):
        bsz, c, n = x.shape
        got, mean = gram.centered_gram_cn(x)
        ref, ref_mean = gram._centered_gram_plain(x)
        torch.cuda.synchronize()
        err = rel_fro(got, ref)
        mean_err = float((mean - ref_mean).abs().max() / ref_mean.abs().max())
        again, _ = gram.centered_gram_cn(x)
        alone, _ = gram.centered_gram_cn(x[-1:].contiguous())
        row = {"phase": phase, "kernel": "centered_gram", "case": case, "shape": [bsz, c, n],
               "dtype": str(x.dtype).split(".")[-1], "main_path": main, "rel_fro_err": err,
               "mean_rel_err": mean_err, "max_abs_err": float((got - ref).abs().max()),
               "bitwise_repeatable": bool(torch.equal(got, again)),
               "alone_equals_batch_bitwise": bool(torch.equal(alone[0], got[-1]))}
        row["symmetric_bitwise"] = bool(torch.equal(got, got.mT))
        x64 = x.double()
        c64 = x64 - x64.mean(-1, keepdim=True)
        g64 = c64 @ c64.mT
        row["rel_fro_err_vs_float64"] = rel_fro(got.double(), g64)
        row["plain_rel_fro_err_vs_float64"] = rel_fro(ref.double(), g64)
        del x64, c64, g64
        # The distinct entries' products, N·C·(C+1) per image, in three
        # TF32 passes; x read once, mean and Gram written once.
        ops = bsz * n * c * (c + 1)
        nbytes = bsz * (n * c * x.element_size() + (c * c + c) * 4)
        bound, by = conv_bound_ms(3 * ops, nbytes, tf32, bw)
        row["ffma_floor_ms"] = ops / flops * 1e3
        # The two passes' own floor: x read twice.
        row["two_pass_floor_ms"] = max(3 * ops / tf32, 2 * bsz * n * c * x.element_size() / bw) * 1e3
        k = 10 if main else 3
        row.update(ms=cuda_ms(lambda: gram.centered_gram_cn(x), k),
                   plain_ms=cuda_ms(lambda: gram._centered_gram_plain(x), k // 2 + 1),
                   library_ms=cuda_ms(lambda: library_gram(x), k // 2 + 1),
                   bound_ms=bound, bound_by=by)
        emit(row)
        check(err <= GRAM_LIMIT and mean_err <= GRAM_LIMIT,
              f"centered_gram vs plain at {case}: gram {err:.2e}, mean {mean_err:.2e} > {GRAM_LIMIT}")
        check(row["rel_fro_err_vs_float64"] <= GRAM_F64_LIMIT,
              f"centered_gram vs float64 at {case}: {row['rel_fro_err_vs_float64']:.2e}")
        check(row["bitwise_repeatable"] and row["alone_equals_batch_bitwise"],
              f"centered_gram at {case}: result depends on the run or the batch")
        check(row["symmetric_bitwise"], f"centered_gram at {case}: G differs from its transpose")
        rows.append(row)

    for level, feats in t["feats"].items():
        run(f"{level}_b4", feats.flatten(2).contiguous(), True)
    if edge_cases:
        for level, feats in t["feats"].items():
            run(f"{level}_b1", feats[:1].flatten(2).contiguous(), False)
        run("relu1_1_b4_f32", t["feats"]["relu1_1"].flatten(2).float().contiguous(), False)
        for level in ("relu1_1", "relu2_1"):  # grouped WCT, four groups: [B·4, C/4, N]
            f = t["feats"][level].flatten(2)
            run(f"{level}_b4_groups4", f.reshape(4 * f.shape[0], f.shape[1] // 4, -1).contiguous(),
                False)
        for n, c in ((7, 256), (132, 512), (1000, 32)):
            run(f"random_n{n}_c{c}_b6", torch.rand(6, c, n, generator=gen).to(DEV), False)
    for case, x in extra:
        run(case, x, False)
    check_hgmma("centered_gram", ("gram_kernel",), phase)
    main_rows = [r for r in rows if r["main_path"]]
    return {"centered_gram": {
        "max_abs_err": max(r["max_abs_err"] for r in main_rows),
        "ms": sum(r["ms"] for r in main_rows), "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": sum(r["bound_ms"] for r in main_rows),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in main_rows) else "bytes",
        "library_ms": sum(r["library_ms"] for r in main_rows)}}


def phase_main_bf16(params, content, style, cfg, out_f32, cache_f32, cfg_f32):
    """The bf16 throughput cascade through the same entry points, then
    the small-conv and centred-Gram entry points on its own relu1_1-tier
    tensors; the launch counts cover both."""
    cache, out, cascade_counts, wall = drive(params, content, style, cfg)
    n_chunks = -(-N_CONTENT // MICROBATCH)
    check(cascade_counts == {**NO_LAUNCHES, "centered_gram": 5 * (1 + n_chunks)},
          f"the bf16 cascade itself launched {cascade_counts}")
    check(out.dtype == torch.float32 and tuple(out.shape) == (N_CONTENT, SIZE, SIZE, 3),
          f"output {out.dtype} {tuple(out.shape)}")
    check(all(cache[lv].stats.kernel.dtype == torch.float32 for lv in cfg.relu_targets),
          "style statistics are not f32")
    check(bool(torch.isfinite(out).all()), "non-finite output")
    check(float(out.min()) >= 0.0 and float(out.max()) <= 1.0, "output outside [0, 1]")

    # The entry points on the cascade's own relu1_1-tier tensors, held
    # against what the cascade's stock ops computed there; their launches
    # are counted from 0 again (making the tensors runs the cascade).
    t = throughput_path_tensors(params, content, cache, cfg)
    reset_counts()
    w_head, b_head = t["head_w"]
    tail = params["decoders"]["relu1_1"]["dec_conv1_1"]
    e1 = conv_small.conv2d_reflect_fused(to_nhwc(t["img1"]), w_head, b_head, relu=True,
                                         impl="pallas_small")
    rgb = conv_small.conv2d_reflect_fused(to_nhwc(t["tr1"]), tail["w"], tail["b"],
                                          impl="pallas_small")
    e1_nchw = conv_small.conv3x3_reflect_small_nchw(t["img1"].contiguous(), w_head, b_head, True)
    rgb_nchw = conv_small.conv3x3_reflect_small_nchw(t["tr1"].contiguous(), tail["w"], tail["b"])
    _, mu = gram.centered_gram_cn(t["f1"].flatten(2))
    torch.cuda.synchronize()
    counts = read_counts()
    # The cascade's own _gram_cn, on the f32 features and on the bf16 ones
    # the throughput cascade has, against a float64 covariance: each within
    # GRAM_F64_LIMIT (one cuBLAS product over all 262,144 columns, which
    # _gram_cn was before, landed 1e-3 away).
    n_px = t["f1"].shape[2] * t["f1"].shape[3]
    f1 = t["f1"].flatten(2)
    f1_32 = f1.float()
    cov32, _ = wct_ops._gram_cn(f1_32)
    cov16, _ = wct_ops._gram_cn(f1)
    f64 = f1.double()
    mu64 = f64.mean(-1)
    c64 = f64 - mu64[..., None]
    cov64 = (c64 @ c64.mT) / (n_px - 1)
    del f64, c64
    entry = {
        "conv_3to64_relu_ulp_excess": ulp_excess(to_nchw(e1), t["f1"], float(b_head.abs().max())),
        "conv_64to3_ulp_excess": ulp_excess(to_nchw(rgb), t["out1"], float(tail["b"].abs().max())),
        "nchw_entry_equals_nhwc_bitwise": bool(torch.equal(e1_nchw, to_nchw(e1))
                                               and torch.equal(rgb_nchw, to_nchw(rgb))),
        "f32_gram_cn_vs_float64_rel_fro": rel_fro(cov32.double(), cov64),
        "bf16_gram_cn_vs_float64_rel_fro": rel_fro(cov16.double(), cov64),
        "mean_vs_float64_rel_err": float((mu.double() - mu64).abs().max() / mu64.abs().max()),
    }
    del cov64
    # What the same covariance costs from each input dtype (after the counts were read).
    entry.update(gram_cn_bf16_ms=cuda_ms(lambda: wct_ops._gram_cn(f1)),
                 gram_cn_f32_ms=cuda_ms(lambda: wct_ops._gram_cn(f1_32)))
    del f1_32
    check(counts == {**NO_LAUNCHES, "conv3x3_small": 2, "conv3x3_small_nchw": 2, "centered_gram": 1},
          f"main_bf16 entry-point calls launched {counts}")
    check(entry["f32_gram_cn_vs_float64_rel_fro"] <= GRAM_F64_LIMIT
          and entry["bf16_gram_cn_vs_float64_rel_fro"] <= GRAM_F64_LIMIT
          and entry["mean_vs_float64_rel_err"] <= GRAM_F64_LIMIT,
          f"the cascade's _gram_cn vs float64: {entry}")
    check(entry["conv_3to64_relu_ulp_excess"] <= 0 and entry["conv_64to3_ulp_excess"] <= 0,
          f"conv2d_reflect_fused vs the cascade's conv: {entry}")
    check(entry["nchw_entry_equals_nhwc_bitwise"], "the small conv's two entries differ")

    out_a0 = cascade.stylize_microbatched(params, content[:MICROBATCH], cache, 0.0, cfg, MICROBATCH)
    out_a1 = cascade.stylize_microbatched(params, content[:MICROBATCH], cache, 1.0, cfg, MICROBATCH)
    a_diff = float((out_a0 - out_a1).abs().mean())
    check(a_diff > 1e-3, f"alpha=0 and alpha=1 outputs barely differ ({a_diff:.2e})")
    a0_err = float((out_a0 - torch.as_tensor(content[:MICROBATCH], device=DEV)).abs().mean())

    single = cascade.stylize_microbatched(params, content[:1], cache, ALPHA, cfg, MICROBATCH)
    check(torch.equal(single[0], out[0]), "bf16 output depends on the submitted batch size")

    d = (out - out_f32).abs().flatten()
    median, q99 = float(d.median()), float(torch.quantile(d, 0.99))
    check(median < COMPOSED_MEDIAN_LIMIT, f"bf16 vs f32 cascade median {median:.3f}")

    # Per level, teacher-forced on the bf16 route's running image: the bf16
    # level against the f32 level on the same input.
    levels = {}
    batch = torch.as_tensor(content[:MICROBATCH], device=DEV)
    x = batch
    for level in cfg.relu_targets:
        one16 = cascade.CascadeConfig(relu_targets=(level,), **THROUGHPUT)
        one32 = cascade.CascadeConfig(relu_targets=(level,), method=cfg_f32.method)
        y16 = cascade.stylize(params, x, cache, ALPHA, one16)
        y32 = cascade.stylize(params, x, cache_f32, ALPHA, one32)
        dl = (y16 - y32).abs().flatten()
        levels[level] = {"q99": float(torch.quantile(dl, 0.99)), "median": float(dl.median())}
        check(levels[level]["q99"] < LEVEL_Q99_LIMIT, f"{level} bf16 vs f32 q99 {levels[level]}")
        x = y16

    runs = 3
    bf16 = lambda: cascade.stylize(params, batch, cache, ALPHA, cfg)  # noqa: E731
    f32 = lambda: cascade.stylize(params, batch, cache_f32, ALPHA, cfg_f32)  # noqa: E731
    turns = [cuda_ms(fn, runs) / MICROBATCH for fn in (f32, bf16, bf16, f32)]
    ms_style = cuda_ms(lambda: cascade.precompute_style(params["encoder"], style, cfg), runs)

    stages = {}
    with torch.no_grad():
        x = to_nchw(batch).to(cfg.dtype)
        for level in cfg.relu_targets:
            enc = lambda: vgg.encode_multi_nchw(params["encoder"], x, (level,), compose_pre=True)[level]  # noqa: E731
            feats = enc()
            wct = lambda: cascade._transform_level(feats, level, cache[level], ALPHA, cfg)  # noqa: E731
            tr = wct()
            dec = lambda: decoder.decode_nchw(params["decoders"][level], tr, level)  # noqa: E731
            stages[level] = {"encode_ms": cuda_ms(enc, runs), "wct_ms": cuda_ms(wct, runs),
                             "decode_ms": cuda_ms(dec, runs)}
            x = dec()
    emit({"phase": "main_bf16", "config": f"CascadeConfig({THROUGHPUT})",
          "size": SIZE, "n_images": N_CONTENT, "microbatch": MICROBATCH, "alpha": ALPHA,
          "launches": cascade_counts, "entry_point_launches": counts, "entry_points": entry,
          "first_run_wall_s": wall,
          "alpha0_vs_alpha1_mean_abs": a_diff, "alpha0_vs_content_mean_abs": a0_err,
          "batch1_vs_batch6_bitwise_equal": True, "vs_f32_median": median, "vs_f32_q99": q99,
          "levels_vs_f32_teacher_forced": levels,
          "ms_per_frame_b4": (turns[1] + turns[2]) / 2,
          "ms_per_frame_b4_f32_unfused": (turns[0] + turns[3]) / 2,
          "ms_per_frame_b4_turns_f32_bf16_bf16_f32": turns, "precompute_style_ms": ms_style,
          "matmul_out_dtype": wct_ops.reductions.has_out_dtype(),
          "stages_b4_ms": stages, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    return counts, out, cache


# The bf16 fused-junction configuration: bf16 activations, the plain
# Newton–Schulz loop, and the bf16 forms of the junction kernels.
BF16_FUSED = dict(compute_dtype="bfloat16", method="newton_schulz_fast", fuse_junction=True)


def phase_main_bf16_fused(params, content, style, cfg, out_f32, cache_f32, cfg_f32, out_bf16,
                          cache_bf16, cfg_bf16):
    """The bf16 fused-junction cascade through the same entry points, held
    to main_bf16's gates against the f32 cascade; its distance from the
    unfused bf16 route is printed."""
    cache, out, counts, wall = drive(params, content, style, cfg)
    n_chunks = -(-N_CONTENT // MICROBATCH)
    expected = {**NO_LAUNCHES, "centered_gram": 5 * (1 + n_chunks), "encoder_head_bf16": n_chunks,
                "junction_bf16": 3 * n_chunks, "decoder_tail_bf16": n_chunks}
    check(counts == expected, f"bf16 fused main path launched {counts}, expected {expected}")
    check(out.dtype == torch.float32 and tuple(out.shape) == (N_CONTENT, SIZE, SIZE, 3),
          f"output {out.dtype} {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "non-finite output")
    check(float(out.min()) >= 0.0 and float(out.max()) <= 1.0, "output outside [0, 1]")

    out_a0 = cascade.stylize_microbatched(params, content[:MICROBATCH], cache, 0.0, cfg, MICROBATCH)
    out_a1 = cascade.stylize_microbatched(params, content[:MICROBATCH], cache, 1.0, cfg, MICROBATCH)
    a_diff = float((out_a0 - out_a1).abs().mean())
    check(a_diff > 1e-3, f"alpha=0 and alpha=1 outputs barely differ ({a_diff:.2e})")
    a0_err = float((out_a0 - torch.as_tensor(content[:MICROBATCH], device=DEV)).abs().mean())

    single = cascade.stylize_microbatched(params, content[:1], cache, ALPHA, cfg, MICROBATCH)
    check(torch.equal(single[0], out[0]), "bf16 fused output depends on the submitted batch size")

    d = (out - out_f32).abs().flatten()
    median, q99 = float(d.median()), float(torch.quantile(d[::4], 0.99))
    check(median < COMPOSED_MEDIAN_LIMIT, f"bf16 fused vs f32 cascade median {median:.3f}")
    du = (out - out_bf16).abs().flatten()
    vs_unfused = {"median": float(du.median()), "q99": float(torch.quantile(du[::4], 0.99)),
                  "max": float(du.max())}

    # Per level, teacher-forced on this route's running image: the bf16
    # fused level (its head, or at relu1_1 its tail) against the f32 level.
    levels = {}
    batch = torch.as_tensor(content[:MICROBATCH], device=DEV)
    x = batch
    for level in cfg.relu_targets:
        one16 = cascade.CascadeConfig(relu_targets=(level,), **BF16_FUSED)
        one32 = cascade.CascadeConfig(relu_targets=(level,), method=cfg_f32.method)
        y16 = cascade.stylize(params, x, cache, ALPHA, one16)
        y32 = cascade.stylize(params, x, cache_f32, ALPHA, one32)
        dl = (y16 - y32).abs().flatten()
        levels[level] = {"q99": float(torch.quantile(dl, 0.99)), "median": float(dl.median())}
        check(levels[level]["q99"] < LEVEL_Q99_LIMIT, f"{level} bf16 fused vs f32 q99 {levels[level]}")
        x = y16

    runs = 3
    fused = lambda: cascade.stylize(params, batch, cache, ALPHA, cfg)  # noqa: E731
    unfused = lambda: cascade.stylize(params, batch, cache_bf16, ALPHA, cfg_bf16)  # noqa: E731
    turns = [cuda_ms(fn, runs) / MICROBATCH for fn in (unfused, fused, fused, unfused)]
    stages = fused_stages(params, batch, cache, cfg)
    emit({"phase": "main_bf16_fused", "config": f"CascadeConfig({BF16_FUSED})",
          "size": SIZE, "n_images": N_CONTENT, "microbatch": MICROBATCH, "alpha": ALPHA,
          "launches": counts, "first_run_wall_s": wall,
          "alpha0_vs_alpha1_mean_abs": a_diff, "alpha0_vs_content_mean_abs": a0_err,
          "batch1_vs_batch6_bitwise_equal": True, "vs_f32_median": median, "vs_f32_q99": q99,
          "vs_bf16_unfused": vs_unfused, "levels_vs_f32_teacher_forced": levels,
          "ms_per_frame_b4": (turns[1] + turns[2]) / 2,
          "ms_per_frame_b4_bf16_unfused": (turns[0] + turns[3]) / 2,
          "ms_per_frame_b4_turns_unfused_fused_fused_unfused": turns,
          "stages_b4_ms": stages, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    return counts


def phase_main_eigh(params, content, style, cache_ns, cfg_ns):
    """The default CascadeConfig() (f32 convs, eigh): main's checks, the
    covariances against float64 at every level, and eigh's share of each
    level's WCT stage."""
    cfg = cascade.CascadeConfig()
    cache, out, counts, wall = drive(params, content, style, cfg)
    n_chunks = -(-N_CONTENT // MICROBATCH)
    check(counts == {**NO_LAUNCHES, "centered_gram": 5 * (1 + n_chunks)},
          f"eigh main path launched {counts}")
    check(tuple(out.shape) == (N_CONTENT, SIZE, SIZE, 3), f"output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "non-finite output")
    check(float(out.min()) >= 0.0 and float(out.max()) <= 1.0, "output outside [0, 1]")
    out_a0 = cascade.stylize_microbatched(params, content[:MICROBATCH], cache, 0.0, cfg, MICROBATCH)
    out_a1 = cascade.stylize_microbatched(params, content[:MICROBATCH], cache, 1.0, cfg, MICROBATCH)
    a_diff = float((out_a0 - out_a1).abs().mean())
    check(a_diff > 1e-3, f"alpha=0 and alpha=1 outputs barely differ ({a_diff:.2e})")
    single = cascade.stylize_microbatched(params, content[:1], cache, ALPHA, cfg, MICROBATCH)
    check(torch.equal(single[0], out[0]), "eigh output depends on the submitted batch size")

    # Per level, on the route's own running image: the covariance against
    # float64, and the WCT stage with the eigh inside it.
    batch = torch.as_tensor(content[:MICROBATCH], device=DEV)
    levels = {}
    runs = 3
    with torch.no_grad():
        x = to_nchw(batch)
        for level in cfg.relu_targets:
            feats = vgg.encode_multi_nchw(params["encoder"], x, (level,))[level]
            f = feats.flatten(2)
            cov, _ = wct_ops._gram_cn(f)
            f64 = f.double()
            c64 = f64 - f64.mean(-1, keepdim=True)
            cov64 = (c64 @ c64.mT) / (f.shape[-1] - 1)
            del f64, c64
            eye = torch.eye(cov.shape[-1], device=DEV)
            a = (cov + wct_ops.DEFAULT_EPS * eye).contiguous()
            wct = lambda: cascade._transform_level(feats, level, cache[level], ALPHA, cfg)  # noqa: E731
            wct_ms, eigh_ms = cuda_ms(wct, runs), cuda_ms(lambda: eigh_ops.eigh_cn(a), runs)
            levels[level] = {"C": cov.shape[-1], "cov_vs_float64_rel_fro": rel_fro(cov.double(), cov64),
                             "wct_ms": wct_ms, "eigh_ms": eigh_ms, "eigh_share": eigh_ms / wct_ms}
            check(levels[level]["cov_vs_float64_rel_fro"] <= GRAM_F64_LIMIT,
                  f"{level} covariance vs float64: {levels[level]}")
            x = decoder.decode_nchw(params["decoders"][level], wct(), level)
    eigh = lambda: cascade.stylize(params, batch, cache, ALPHA, cfg)  # noqa: E731
    ns = lambda: cascade.stylize(params, batch, cache_ns, ALPHA, cfg_ns)  # noqa: E731
    turns = [cuda_ms(fn, runs) / MICROBATCH for fn in (ns, eigh, eigh, ns)]
    emit({"phase": "main_eigh", "config": "CascadeConfig()", "size": SIZE, "n_images": N_CONTENT,
          "microbatch": MICROBATCH, "alpha": ALPHA, "launches": counts, "first_run_wall_s": wall,
          "alpha0_vs_alpha1_mean_abs": a_diff, "batch1_vs_batch6_bitwise_equal": True,
          "levels_b4": levels, "ms_per_frame_b4": (turns[1] + turns[2]) / 2,
          "ms_per_frame_b4_newton_schulz_pallas": (turns[0] + turns[3]) / 2,
          "ms_per_frame_b4_turns_ns_eigh_eigh_ns": turns,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})


# The eigh kernel against float64 eigh of the same f32 matrices: the WCT's
# A^-1/2 (hard 1e-5 mask) no farther than twice cuSOLVER's f32 eigh on the
# trained covariances (largest over the batch, per level); on seeded SPD
# matrices no farther than twice its plain twin's; everywhere eigenvectors
# orthonormal and eigenvalues within C 2^-23 of float64, relative to the
# largest.
EIGH_VS_LIBRARY = 2.0


def eigh_errors(a, s, u) -> dict:
    """Per matrix of ``a [B, C, C]``: ``‖UᵀU − I‖_F``, the eigenvalues'
    largest error over the largest, and ``A^-1/2``'s relative Frobenius
    distance, each from float64 ``eigh`` of the same matrix."""
    a64 = a.double()
    s64, u64 = torch.linalg.eigh(a64)
    sd, ud = s.double(), u.double()

    def minus_half(s_, u_):
        keep = s_ > wct_ops.DEFAULT_TRUNC
        return (u_ * torch.where(keep, s_.abs() ** -0.5, 0.0)[..., None, :]) @ u_.mT

    ref = minus_half(s64, u64)
    eye = torch.eye(a.shape[-1], dtype=torch.float64, device=a.device)
    return {"orth": (ud.mT @ ud - eye).norm(dim=(1, 2)).tolist(),
            "eigenvalues": ((sd - s64).abs().amax(-1) / s64.abs().amax(-1)).tolist(),
            "minus_half": ((minus_half(sd, ud) - ref).flatten(1).norm(dim=1)
                           / ref.flatten(1).norm(dim=1)).tolist()}


def eigh_flops(c: int) -> float:
    """FLOP a C x C symmetric eigendecomposition needs, whatever computes it:
    about 9 C^3 (tridiagonal reduction, its eigenvectors, back-transform)."""
    return 9.0 * c**3


def eigh_algorithm_flops(c: int, sweeps: float) -> float:
    """FLOP of one matrix's block-Jacobi decomposition (csrc/eigh_jacobi.cu's
    count): about 128 np^2 a round, np / 16 - 1 rounds a sweep."""
    np_ = eigh_ops.padded_edge(c)
    return sweeps * (np_ // 16 - 1) * 128.0 * np_ * np_


def seeded_spd(b: int, c: int, seed: int):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((b, c, c)))
    eigs = np.geomspace(50.0, 50.0e-6, c)
    return torch.from_numpy(((q * eigs) @ q.transpose(0, 2, 1)).astype(np.float32)).to(DEV)


def phase_eigh_kernel(params, content, style, name) -> dict:
    """The eigh kernel: on the trained covariances of a microbatch at every
    level (kernel, its plain twin on the card and cuSOLVER's eigh against
    float64; a matrix alone = in the batch, bitwise), on seeded SPD matrices
    at every C the cascade and wct_groups give and B = 1, 2, 4, 8, and on one
    f32 microbatch of the default route: 5 launches, no matrix at the sweep
    cap, no synchronisation (``torch.cuda.set_sync_debug_mode("error")``)."""
    cfg = cascade.CascadeConfig()
    covs = level_covariances(params, content[:MICROBATCH], cfg)
    eps = 2.0 ** -23
    levels, ms, plain_ms, library_ms, err = {}, 0.0, 0.0, 0.0, 0.0
    flops, nbytes, algorithm_flops = 0.0, 0.0, 0.0
    for level, a in covs.items():
        c = a.shape[-1]
        s, u = eigh_ops.eigh_cuda(a)
        s1, u1 = eigh_ops.eigh_cuda(a[:1].contiguous())
        check(torch.equal(s1[0], s[0]) and torch.equal(u1[0], u[0]),
              f"eigh {level}: a matrix alone differs from it in the batch")
        st, ut, sweeps = eigh_ops._eigh_plain(a)
        sl, ul = torch.linalg.eigh(a)
        row = {"C": c, "twin_sweeps": sweeps.tolist(), "kernel": eigh_errors(a, s, u),
               "twin": eigh_errors(a, st, ut), "library": eigh_errors(a, sl, ul),
               "eigenvalues_vs_twin": float((s - st).abs().max() / st.abs().max())}
        kmax, lmax = max(row["kernel"]["minus_half"]), max(row["library"]["minus_half"])
        check(kmax <= EIGH_VS_LIBRARY * lmax, f"eigh {level}: A^-1/2 {kmax:.3e} vs cuSOLVER {lmax:.3e}")
        check(max(row["kernel"]["orth"]) <= c * eps and max(row["kernel"]["eigenvalues"]) <= c * eps,
              f"eigh {level}: {row['kernel']}")
        row["ms"] = cuda_ms(lambda: eigh_ops.eigh_cuda(a))
        row["plain_ms"] = cuda_ms(lambda: eigh_ops._eigh_plain(a), 1, 1)
        row["library_ms"] = cuda_ms(lambda: torch.linalg.eigh(a), 2, 1)
        ms, plain_ms, library_ms = ms + row["ms"], plain_ms + row["plain_ms"], library_ms + row["library_ms"]
        flops += a.shape[0] * eigh_flops(c)
        nbytes += a.shape[0] * (2 * c * c + c) * 4  # read A, write U and s
        algorithm_flops += sum(eigh_algorithm_flops(c, float(n)) for n in sweeps.tolist())
        err = max(err, row["eigenvalues_vs_twin"])
        levels[level] = row
    shapes = {}
    for c in (4, 7, 8, 16, 32, 33, 64, 100, 128, 256, 512):
        a = seeded_spd(8, c, c)
        s, u = eigh_ops.eigh_cuda(a)
        for b in (1, 2, 4):
            sb, ub = eigh_ops.eigh_cuda(a[:b].contiguous())
            check(torch.equal(sb, s[:b]) and torch.equal(ub, u[:b]), f"eigh C={c}: batch {b} differs")
        st, ut, _ = eigh_ops._eigh_plain(a[:2])
        k, t = eigh_errors(a, s, u), eigh_errors(a[:2], st, ut)
        check(max(k["orth"]) <= max(c, 32) * eps and max(k["eigenvalues"]) <= max(c, 32) * eps,
              f"eigh C={c}: {k}")
        check(max(k["minus_half"][:2]) <= 2.0 * max(t["minus_half"]) + 1e-6,
              f"eigh C={c}: A^-1/2 {k['minus_half'][:2]} vs twin {t['minus_half']}")
        shapes[c] = {"kernel": k, "twin": t}
    cache = cascade.precompute_style(params["encoder"], style, cfg)
    batch = torch.as_tensor(content[:MICROBATCH], device=DEV)
    cascade.stylize(params, batch, cache, ALPHA, cfg)
    torch.cuda.synchronize()
    before = eigh_ops.eigh_cuda.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        cascade.stylize(params, batch, cache, ALPHA, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = eigh_ops.eigh_cuda.launches - before
    capped = eigh_ops.capped_sweeps()
    check(launches == 5, f"an f32 microbatch launched the eigh kernel {launches} times")
    check(capped == 0, f"{capped} matrices reached the sweep cap")
    bound_ms, bound_by = conv_bound_ms(flops, nbytes, *peaks(name))
    emit({"phase": "eigh_kernel", "levels_b4": levels, "seeded_spd_b8": shapes,
          "launches_per_f32_microbatch": launches, "capped_sweeps": capped,
          "no_sync_in_f32_microbatch": True, "ms_b4": ms, "plain_ms_b4": plain_ms,
          "library_ms_b4": library_ms, "bound_ms_b4": bound_ms, "flops_b4": flops,
          "algorithm_flops_b4": algorithm_flops,
          "algorithm_ms_at_ffma_peak_b4": algorithm_flops / peaks(name)[0] * 1e3})
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "launches": launches}


def route_checks(params, content, cache, cfg, out, label) -> None:
    """f32 output of the content's shape, finite, in [0, 1], and an image's
    output the same bits alone as in the batch."""
    check(out.dtype == torch.float32 and tuple(out.shape) == (N_CONTENT, SIZE, SIZE, 3),
          f"{label} output {out.dtype} {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
    check(float(out.min()) >= 0.0 and float(out.max()) <= 1.0, f"{label}: output outside [0, 1]")
    single = cascade.stylize_microbatched(params, content[:1], cache, ALPHA, cfg, MICROBATCH)
    check(torch.equal(single[0], out[0]), f"{label} output depends on the submitted batch size")


# AdaIN's moments against float64, relative to the largest style std.
ADAIN_MOMENTS_LIMIT = 1e-4


def phase_main_adain(params, content, style):
    """transform='adain', f32, unfused: AdaIN's moments are the centred-Gram
    kernel's mean and diagonal (one launch per level and call)."""
    cfg = cascade.CascadeConfig(transform="adain")
    cache, out, counts, wall = drive(params, content, style, cfg)
    n_chunks = -(-N_CONTENT // MICROBATCH)
    expected = {**NO_LAUNCHES, "centered_gram": 5 * (1 + n_chunks)}
    check(counts == expected, f"main_adain launched {counts}, expected {expected}")
    route_checks(params, content, cache, cfg, out, "main_adain")

    # Per level, teacher-forced on the route's running image: at α = 1 the
    # transformed features carry the style's channel means and stds (a
    # channel of variance v leaves with std σ_s·√(v / (v + eps))).
    batch = torch.as_tensor(content[:MICROBATCH], device=DEV)
    levels = {}
    with torch.no_grad():
        x = to_nchw(batch)
        for level in cfg.relu_targets:
            feats = vgg.encode_multi_nchw(params["encoder"], x, (level,))[level]
            tr = cascade._transform_level(feats, level, cache[level], 1.0, cfg).flatten(2).double()
            var_c = feats.flatten(2).double().var(-1, unbiased=False)
            st = cache[level].adain
            std_s = st.std.double()
            want_std = std_s * torch.sqrt(var_c / (var_c + adain_ops.DEFAULT_EPS))
            scale = float(std_s.max())
            levels[level] = {
                "mean_err": float((tr.mean(-1) - st.mean.double()).abs().max()) / scale,
                "std_err": float((tr.std(-1, unbiased=False) - want_std).abs().max()) / scale}
            del tr
            check(levels[level]["mean_err"] <= ADAIN_MOMENTS_LIMIT
                  and levels[level]["std_err"] <= ADAIN_MOMENTS_LIMIT,
                  f"main_adain {level}: moments {levels[level]} > {ADAIN_MOMENTS_LIMIT}")
            if level == "relu1_1":  # the moments route against the plain two-pass it replaces
                f1 = feats.flatten(2)
                levels[level].update(moments_gram_ms=cuda_ms(lambda: gram.moments_cn(f1), 10),
                                     moments_two_pass_ms=cuda_ms(lambda: reductions.moments0(f1.mT), 10))
            x = decoder.decode_nchw(params["decoders"][level],
                                    cascade._transform_level(feats, level, cache[level], ALPHA, cfg),
                                    level)
        # α = 0 is the content path: each level's encode → decode.
        out_a0 = cascade.stylize_microbatched(params, content[:MICROBATCH], cache, 0.0, cfg,
                                              MICROBATCH)
        x = to_nchw(batch)
        for level in cfg.relu_targets:
            x = decoder.decode_nchw(params["decoders"][level],
                                    vgg.encode_multi_nchw(params["encoder"], x, (level,))[level], level)
        round_trip = to_nhwc(x.clamp(0.0, 1.0))
    a0_err = float((out_a0 - round_trip).abs().max())
    check(a0_err <= 1e-6, f"main_adain: alpha=0 is {a0_err:.2e} from the content path")

    ms_frame = cuda_ms(lambda: cascade.stylize(params, batch, cache, ALPHA, cfg), 3) / MICROBATCH
    emit({"phase": "main_adain", "config": "CascadeConfig(transform='adain')", "size": SIZE,
          "n_images": N_CONTENT, "microbatch": MICROBATCH, "alpha": ALPHA, "launches": counts,
          "first_run_wall_s": wall, "batch1_vs_batch6_bitwise_equal": True,
          "alpha0_vs_content_path_max_abs": a0_err,
          "alpha0_equals_content_path_bitwise": bool(torch.equal(out_a0, round_trip)),
          "levels_moments_vs_float64": levels, "ms_per_frame_b4": ms_frame,
          "precompute_style_ms": cuda_ms(lambda: cascade.precompute_style(params["encoder"], style,
                                                                          cfg), 3),
          "stages_b4_ms": unfused_stages(params, batch, cache, cfg),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    return out, cache, cfg


ADAIN_FUSED = dict(compute_dtype="bfloat16", method="newton_schulz_fast", fuse_junction=True,
                   transform="adain")


def phase_main_adain_fused(params, content, style, out_f32, cache_f32, cfg_f32):
    """AdaIN on the bf16 fused route: the bf16 head and junctions, and the
    tail with each image's diagonal AdaIN affine folded into its weights;
    held to main_adain with the reference's bf16 gates."""
    cfg = cascade.CascadeConfig(**ADAIN_FUSED)
    cache, out, counts, wall = drive(params, content, style, cfg)
    n_chunks = -(-N_CONTENT // MICROBATCH)
    expected = {**NO_LAUNCHES, "centered_gram": 5 * (1 + n_chunks), "encoder_head_bf16": n_chunks,
                "junction_bf16": 3 * n_chunks, "decoder_tail_bf16": n_chunks}
    check(counts == expected, f"main_adain_fused launched {counts}, expected {expected}")
    route_checks(params, content, cache, cfg, out, "main_adain_fused")
    d = (out - out_f32).abs().flatten()
    median, q99 = float(d.median()), float(torch.quantile(d[::4], 0.99))
    check(median < COMPOSED_MEDIAN_LIMIT, f"main_adain_fused vs main_adain median {median:.3f}")

    levels = {}
    batch = torch.as_tensor(content[:MICROBATCH], device=DEV)
    x = batch
    for level in cfg.relu_targets:
        one16 = cascade.CascadeConfig(relu_targets=(level,), **ADAIN_FUSED)
        one32 = cascade.CascadeConfig(relu_targets=(level,), transform="adain")
        y16 = cascade.stylize(params, x, cache, ALPHA, one16)
        dl = (y16 - cascade.stylize(params, x, cache_f32, ALPHA, one32)).abs().flatten()
        levels[level] = {"q99": float(torch.quantile(dl, 0.99)), "median": float(dl.median())}
        check(levels[level]["q99"] < LEVEL_Q99_LIMIT, f"{level} bf16 AdaIN vs f32 q99 {levels[level]}")
        if level == "relu1_1":  # the tail on this route's own features
            with torch.no_grad():
                f = vgg.encode_multi_nchw(params["encoder"], to_nchw(x).to(cfg.dtype),
                                          ("relu1_1",))["relu1_1"].contiguous()
                scale, bias = adain_ops.adain_transform_cn(f.flatten(2), cache[level].adain, ALPHA)
                conv = params["decoders"][level]["dec_conv1_1"]
                wf, bf = decoder.fold_affine_into_conv(scale, bias, conv["w"], conv["b"])
                got = junction.decoder_tail_cuda(f, wf, bf, False)
                tail = {"vs_float64_rule": bf16_agreement(
                            got, junction._decoder_tail_plain(f, wf, bf, False, acc=torch.float64)),
                        "vs_plain": bf16_agreement(got, junction._decoder_tail_plain(f, wf, bf, False))}
            check(all(v["bitwise"] >= BF16_BITWISE and v["within_ulp"] == 1.0 for v in tail.values()),
                  f"the AdaIN-folded bf16 tail: {tail}")
        x = y16

    fused = lambda: cascade.stylize(params, batch, cache, ALPHA, cfg)  # noqa: E731
    f32 = lambda: cascade.stylize(params, batch, cache_f32, ALPHA, cfg_f32)  # noqa: E731
    turns = [cuda_ms(fn, 3) / MICROBATCH for fn in (f32, fused, fused, f32)]
    emit({"phase": "main_adain_fused", "config": f"CascadeConfig({ADAIN_FUSED})", "size": SIZE,
          "n_images": N_CONTENT, "microbatch": MICROBATCH, "alpha": ALPHA, "launches": counts,
          "first_run_wall_s": wall, "batch1_vs_batch6_bitwise_equal": True,
          "vs_f32_median": median, "vs_f32_q99": q99, "levels_vs_f32_teacher_forced": levels,
          "tail_adain_folded": tail, "ms_per_frame_b4": (turns[1] + turns[2]) / 2,
          "ms_per_frame_b4_adain_f32": (turns[0] + turns[3]) / 2,
          "ms_per_frame_b4_turns_f32_fused_fused_f32": turns,
          "stages_b4_ms": fused_stages(params, batch, cache, cfg),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})


# The swap at relu5_1 against a float64 evaluation on the same whitened maps:
# the argmax at ≥ 99.9 % of the locations (near-tied patches may flip), and
# where every patch covering a pixel agrees, the swapped map within 1e-5 of
# the map's largest value.
SWAP_ARGMAX_SHARE, SWAP_MAP_LIMIT = 0.999, 1e-5


def phase_main_swap5(params, content, style, cache_main, cfg_main):
    """swap5 with newton_schulz_pallas: Newton–Schulz and the Gram as on
    main (the swap level's content and style whitening take one launch each),
    the correlation and transposed convs in full f32."""
    cfg = cascade.CascadeConfig(method="newton_schulz_pallas", swap5=True)
    cache, out, counts, wall = drive(params, content, style, cfg)
    n_chunks = -(-N_CONTENT // MICROBATCH)
    # Per level one Newton–Schulz and one Gram for the style (at relu5_1 one
    # decomposition gives both its kernels) and for each microbatch.
    expected = {**NO_LAUNCHES, "ns_sqrtm": 5 * (1 + n_chunks), "centered_gram": 5 * (1 + n_chunks)}
    check(counts == expected, f"main_swap5 launched {counts}, expected {expected}")
    route_checks(params, content, cache, cfg, out, "main_swap5")

    batch = torch.as_tensor(content[:MICROBATCH], device=DEV)
    ps, stride, ss_alpha = cfg.ss_patch_size, cfg.ss_stride, cfg.ss_alpha
    with torch.no_grad():
        feats = vgg.encode_multi_nchw(params["encoder"], to_nchw(batch), ("relu5_1",))["relu5_1"]
        b, c, h, w = feats.shape
        x = feats.flatten(2)
        w_c, mu_c = wct_ops.whitening_kernel_cn(x, method=cfg.method)
        white = swap_ops.whiten_cn(x, w_c, mu_c).reshape(b, c, h, w)
        fs_white = cache["relu5_1"].fs_white
        filters, filters_n = swap_ops._filters(fs_white, ps, stride)
        best = torch.cat([swap_ops._best_patches(white[i : i + 1], filters_n, stride)
                          for i in range(b)])
        f64 = filters.double()
        fn64 = f64 / f64.flatten(1).norm(dim=1).clamp_min(1e-8)[:, None, None, None]
        best64 = F.conv2d(white.double(), fn64, stride=stride).argmax(1)
        agree = best == best64
        share = float(agree.float().mean())
        swapped = swap_ops.style_swap_nchw(white, fs_white, ss_alpha, ps, stride).double()
        one_hot = F.one_hot(best64, f64.shape[0]).permute(0, 3, 1, 2).double()
        ones = torch.ones((1, 1, ps, ps), dtype=torch.float64, device=DEV)
        counts64 = F.conv_transpose2d(torch.ones_like(one_hot[:, :1]), ones, stride=stride)
        recon = F.conv_transpose2d(one_hot, f64, stride=stride) / counts64
        swapped64 = ss_alpha * recon + (1.0 - ss_alpha) * white.double()
        covered_by_flip = F.conv_transpose2d((~agree).double()[:, None], ones, stride=stride) > 0
        map_err = float(((swapped - swapped64).abs() * ~covered_by_flip).max()
                        / swapped64.abs().max())
        del one_hot, recon, swapped64
    check(share >= SWAP_ARGMAX_SHARE, f"main_swap5: argmax agrees with float64 at {share:.5f}")
    check(map_err <= SWAP_MAP_LIMIT, f"main_swap5: swapped map {map_err:.2e} from float64")

    # ss_alpha = 0 leaves the whitened map as it is: the swap level is the
    # plain WCT level, within main's bar against its plain twin.
    one_swap = cascade.CascadeConfig(relu_targets=("relu5_1",), method=cfg.method, swap5=True,
                                     ss_alpha=0.0)
    one_wct = cascade.CascadeConfig(relu_targets=("relu5_1",), method=cfg.method)
    y_swap = cascade.stylize(params, batch, cascade.precompute_style(params["encoder"], style,
                                                                     one_swap), ALPHA, one_swap)
    y_wct = cascade.stylize(params, batch, cache_main, ALPHA, one_wct)
    d = (y_swap - y_wct).abs().flatten()
    ss0 = {"q99": float(torch.quantile(d, 0.99)), "max": float(d.max())}
    check(ss0["q99"] <= 5e-3, f"main_swap5: ss_alpha=0 vs the WCT level {ss0}")

    # The swap's two convs at this shape, each under cuDNN and PyTorch's own
    # conv, and the choice ops/convs.py made for it.
    x0 = white[:1].contiguous()
    one_hot = F.one_hot(best[:1], filters.shape[0]).permute(0, 3, 1, 2).float()
    swap_convs = {}
    for name, conv, key in (
        ("correlation", lambda: F.conv2d(x0, filters_n, stride=stride),
         ("conv2d", tuple(x0.shape), tuple(filters_n.shape), stride, x0.device)),
        ("transposed", lambda: F.conv_transpose2d(one_hot, filters, stride=stride),
         ("conv_transpose2d", tuple(one_hot.shape), tuple(filters.shape), stride, one_hot.dtype,
          one_hot.device)),
    ):
        times = {}
        for enabled in (True, False):
            with convs._cudnn(enabled):
                times["cudnn_ms" if enabled else "pytorch_ms"] = cuda_ms(conv, 5)
        swap_convs[name] = {**times, "uses_cudnn": convs._CUDNN_OK.get(key)}
    ms_frame = cuda_ms(lambda: cascade.stylize(params, batch, cache, ALPHA, cfg), 3) / MICROBATCH
    emit({"phase": "main_swap5", "config": "CascadeConfig(method='newton_schulz_pallas', swap5=True)",
          "size": SIZE, "n_images": N_CONTENT, "microbatch": MICROBATCH, "alpha": ALPHA,
          "launches": counts, "first_run_wall_s": wall, "batch1_vs_batch6_bitwise_equal": True,
          "relu5_1_patches": int(filters.shape[0]), "argmax_share_vs_float64": share,
          "swapped_map_vs_float64_rel_max": map_err, "ss_alpha0_vs_wct_level": ss0,
          "swap_convs_b1": swap_convs, "ms_per_frame_b4": ms_frame,
          "stages_b4_ms": unfused_stages(params, batch, cache, cfg),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})


class record_shapes:
    """Within the block, each call of the Gram and Newton–Schulz entry
    points the WCT calls (one kernel launch each on the card) records its
    input's shape; the kernels and their counts are untouched."""

    def __enter__(self):
        self.shapes = {"centered_gram": [], "ns_sqrtm": []}
        self.saved = gram.centered_gram_cn, sqrtm.newton_schulz_sqrtm

        def wrap(fn, name):
            def recorded(x, *a, **kw):
                self.shapes[name].append(tuple(x.shape))
                return fn(x, *a, **kw)
            return recorded

        gram.centered_gram_cn = wrap(self.saved[0], "centered_gram")
        sqrtm.newton_schulz_sqrtm = wrap(self.saved[1], "ns_sqrtm")
        return self.shapes

    def __exit__(self, *exc):
        gram.centered_gram_cn, sqrtm.newton_schulz_sqrtm = self.saved


def phase_main_groups(params, content, style, name):
    """wct_groups=4 with newton_schulz_pallas: one Gram launch and one
    Newton–Schulz launch per level and call, on the groups of every image
    at once ([B·4, C/4, N] and [B·4, C/4, C/4])."""
    groups = 4
    cfg = cascade.CascadeConfig(method="newton_schulz_pallas", wct_groups=groups)
    with record_shapes() as shapes:
        cache, out, counts, wall = drive(params, content, style, cfg)
    n_chunks = -(-N_CONTENT // MICROBATCH)
    expected = {**NO_LAUNCHES, "ns_sqrtm": 5 * (1 + n_chunks), "centered_gram": 5 * (1 + n_chunks)}
    check(counts == expected, f"main_groups launched {counts}, expected {expected}")
    want_gram = [(groups, vgg.TARGET_CHANNELS[t] // groups, (SIZE // vgg.TARGET_SCALE[t]) ** 2)
                 for t in cfg.relu_targets]
    want_gram += [(MICROBATCH * groups, *s[1:]) for s in want_gram] * n_chunks
    want_ns = [(b, cg, cg) for b, cg, _ in want_gram]
    check(shapes == {"centered_gram": want_gram, "ns_sqrtm": want_ns},
          f"main_groups shapes {shapes}")
    route_checks(params, content, cache, cfg, out, "main_groups")

    batch = torch.as_tensor(content[:MICROBATCH], device=DEV)
    levels = {}
    with torch.no_grad():
        x = to_nchw(batch)
        for level in cfg.relu_targets:
            feats = vgg.encode_multi_nchw(params["encoder"], x, (level,))[level]
            f = feats.flatten(2)
            cov, _ = wct_ops._grouped_gram_cn(f, groups)
            b, c, n = f.shape
            g64 = f.double().reshape(b * groups, c // groups, n)
            g64 = g64 - g64.mean(-1, keepdim=True)
            cov64 = g64 @ g64.mT / (n - 1)
            del g64
            a = (cov + wct_ops.DEFAULT_EPS * torch.eye(c // groups, device=DEV)).contiguous()
            sq, _ = sqrtm.ns_sqrtm_cuda(a)
            levels[level] = {"shape": list(a.shape),
                             "cov_vs_float64_rel_fro": rel_fro(cov.double(), cov64),
                             "ns_vs_float64_iteration": rel_fro(sq.double(), ns_float64(a, sqrtm.DEFAULT_ITERS)),
                             "gram_ms": cuda_ms(lambda: gram.centered_gram_cuda(f.reshape(b * groups, c // groups, n)), 5),
                             "ns_ms": cuda_ms(lambda: sqrtm.ns_sqrtm_cuda(a), 5)}
            levels[level]["ns_bound_ms"] = ns_bound_ms(a.shape[0], a.shape[-1], sqrtm.DEFAULT_ITERS,
                                                       tf32_peak(name), peaks(name)[1])[0]
            check(levels[level]["cov_vs_float64_rel_fro"] <= GRAM_F64_LIMIT,
                  f"main_groups {level} block covariances: {levels[level]}")
            check(levels[level]["ns_vs_float64_iteration"] <= NS_F64_LIMIT,
                  f"main_groups {level} Newton–Schulz: {levels[level]}")
            x = decoder.decode_nchw(params["decoders"][level],
                                    cascade._transform_level(feats, level, cache[level], ALPHA, cfg),
                                    level)
    ms_frame = cuda_ms(lambda: cascade.stylize(params, batch, cache, ALPHA, cfg), 3) / MICROBATCH
    emit({"phase": "main_groups",
          "config": "CascadeConfig(method='newton_schulz_pallas', wct_groups=4)", "size": SIZE,
          "n_images": N_CONTENT, "microbatch": MICROBATCH, "alpha": ALPHA, "launches": counts,
          "first_run_wall_s": wall, "batch1_vs_batch6_bitwise_equal": True,
          "launch_shapes": {k: sorted(set(v)) for k, v in shapes.items()}, "levels_b4": levels,
          "ms_per_frame_b4": ms_frame, "stages_b4_ms": unfused_stages(params, batch, cache, cfg),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})


def keep_masks(f, rel):
    """The rel_trunc keep mask of each image's covariance of ``f [B, C, N]``:
    the cascade's (the Gram kernel, the eigh kernel) and float64's."""
    cov, _ = wct_ops._gram_cn(f)
    eye = torch.eye(cov.shape[-1], device=DEV)
    s32 = eigh_ops.eigh_cn((cov + wct_ops.DEFAULT_EPS * eye).contiguous())[0]
    f64 = f.double()
    c64 = f64 - f64.mean(-1, keepdim=True)
    s64 = torch.linalg.eigvalsh(c64 @ c64.mT / (f.shape[-1] - 1)
                                + wct_ops.DEFAULT_EPS * eye.double())
    return (wct_ops.keep_mask(s32, wct_ops.DEFAULT_TRUNC, rel=rel),
            wct_ops.keep_mask(s64, wct_ops.DEFAULT_TRUNC, rel=rel))


def phase_main_trunc(params, content, style):
    """One batch of rel_trunc=1e-3 (eigh): every level's keep mask, content
    and style, equals a float64 eigh's (wct_tpu/ops/wct.py:137-147)."""
    cfg = cascade.CascadeConfig(rel_trunc=1e-3)
    cache, out, counts, wall = drive(params, content[:MICROBATCH], style, cfg)
    check(counts == {**NO_LAUNCHES, "centered_gram": 10}, f"main_trunc launched {counts}")
    check(bool(torch.isfinite(out).all()) and float(out.min()) >= 0.0 and float(out.max()) <= 1.0,
          "main_trunc: output not finite in [0, 1]")
    batch = torch.as_tensor(content[:MICROBATCH], device=DEV)
    levels = {}
    with torch.no_grad():
        style_feats = vgg.encode_multi_nchw(params["encoder"], to_nchw(torch.as_tensor(
            style[None], device=DEV)), cfg.relu_targets)
        x = to_nchw(batch)
        for level in cfg.relu_targets:
            feats = vgg.encode_multi_nchw(params["encoder"], x, (level,))[level]
            row = {}
            for side, f in (("content", feats.flatten(2)), ("style", style_feats[level].flatten(2))):
                got, want = keep_masks(f, cfg.rel_trunc)
                row[side] = {"kept": got.sum(-1).tolist(), "equal": bool(torch.equal(got, want))}
            levels[level] = row
            check(row["content"]["equal"] and row["style"]["equal"],
                  f"main_trunc {level}: keep mask differs from float64's: {row}")
            x = decoder.decode_nchw(params["decoders"][level],
                                    cascade._transform_level(feats, level, cache[level], ALPHA, cfg),
                                    level)
    ms_frame = cuda_ms(lambda: cascade.stylize(params, batch, cache, ALPHA, cfg), 3) / MICROBATCH
    emit({"phase": "main_trunc", "config": "CascadeConfig(rel_trunc=1e-3)", "size": SIZE,
          "n_images": MICROBATCH, "alpha": ALPHA, "launches": counts, "first_run_wall_s": wall,
          "keep_masks_equal_float64": levels, "ms_per_frame_b4": ms_frame,
          "stages_b4_ms": unfused_stages(params, batch, cache, cfg),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})


# The fold and the ring rewrite the same math, so the f32 route is held to
# its unfolded, padded output by phase main's gate against plain.
REWRITE_Q99_LIMIT = 5e-3


def rewrite_gates(params, content, label, cfg, cache, out, counts, base_counts, out_f32,
                  cache_f32, cfg_f32) -> dict:
    """The gates of a rewritten route against its own route: the launch
    counts, route_checks, and q99 ≤ REWRITE_Q99_LIMIT against the f32
    output (f32), or main_bf16's bars against the f32 cascade (bf16: the
    median, and per level, teacher-forced on the rewritten route's running
    image, q99 against the f32 level)."""
    check(counts == base_counts, f"{label} launched {counts}, its route {base_counts}")
    route_checks(params, content, cache, cfg, out, label)
    d = (out - out_f32).abs().flatten()
    row = {"vs_f32_median": float(d.median()), "vs_f32_q99": float(torch.quantile(d[::3], 0.99)),
           "vs_f32_max": float(d.max())}
    if cfg.dtype == torch.float32:
        check(row["vs_f32_q99"] <= REWRITE_Q99_LIMIT, f"{label} vs its f32 route {row}")
        return row
    check(row["vs_f32_median"] < COMPOSED_MEDIAN_LIMIT, f"{label} vs f32 {row}")
    levels, x = {}, torch.as_tensor(content[:MICROBATCH], device=DEV)
    for level in cfg.relu_targets:
        y16 = cascade.stylize(params, x, cache, ALPHA, dataclasses.replace(cfg, relu_targets=(level,)))
        y32 = cascade.stylize(params, x, cache_f32, ALPHA,
                              dataclasses.replace(cfg_f32, relu_targets=(level,)))
        dl = (y16 - y32).abs().flatten()
        levels[level] = {"q99": float(torch.quantile(dl, 0.99)), "median": float(dl.median())}
        check(levels[level]["q99"] < LEVEL_Q99_LIMIT, f"{label} {level} vs f32 {levels[level]}")
        x = y16
    row["levels_vs_f32_teacher_forced"] = levels
    return row


def fold_decode_ms(params, batch, cache, cfg, cfg_fold, runs=3) -> dict:
    """relu2_1 and relu1_1, teacher-forced on the unfolded route's running
    image: the unfolded transform and decode, the fold's affine and folded
    decode, ms each; at relu1_1 also the folded 64→3 conv as the fold runs
    it (one grouped conv) and through ``decoder_tail_cuda`` on the same
    folded weights."""
    enc, out = params["encoder"], {}
    with torch.no_grad():
        x = to_nchw(batch).to(cfg.dtype)
        for level in cfg.relu_targets:
            feats = vgg.encode_multi_nchw(enc, x, (level,), compose_pre=cfg.compose_conv0)[level]
            dec_p = params["decoders"][level]
            tr = cascade._transform_level(feats, level, cache[level], ALPHA, cfg)
            if level in ("relu2_1", "relu1_1"):
                m, bias = cascade._level_affine(feats, level, cache[level], ALPHA, cfg_fold)
                row = {
                    "unfolded_transform_ms": cuda_ms(
                        lambda: cascade._transform_level(feats, level, cache[level], ALPHA, cfg), runs),
                    "unfolded_decode_ms": cuda_ms(lambda: decoder.decode_nchw(dec_p, tr, level), runs),
                    "fold_affine_ms": cuda_ms(
                        lambda: cascade._level_affine(feats, level, cache[level], ALPHA, cfg_fold), runs),
                    "folded_decode_ms": cuda_ms(
                        lambda: decoder.decode_folded_nchw(dec_p, feats, level, m, bias), runs),
                }
                if level == "relu1_1":
                    conv = dec_p["dec_conv1_1"]
                    wf, bf = decoder.fold_affine_into_conv(m, bias, conv["w"], conv["b"])
                    grouped = convs.conv2d_reflect_perimage_nchw(feats, wf, bf)
                    tail = junction.decoder_tail_cuda(feats.contiguous(), wf, bf)
                    row.update(
                        grouped_conv_ms=cuda_ms(lambda: convs.conv2d_reflect_perimage_nchw(feats, wf, bf), runs),
                        decoder_tail_cuda_ms=cuda_ms(
                            lambda: junction.decoder_tail_cuda(feats.contiguous(), wf, bf), runs),
                        tail_vs_grouped_max_abs=float((tail.float() - grouped.float()).abs().max()))
                out[level] = row
            x = decoder.decode_nchw(dec_p, tr, level)
    return out


def on_both_routes(**fields) -> dict:
    """A rewrite's variants for ``phase_rewrite``: the f32
    Newton–Schulz-kernel route and the bf16 throughput route, each with
    ``fields`` set."""
    return {route: (route, fields) for route in ("f32_ns_pallas", "bf16_throughput")}


def phase_rewrite(params, content, style, routes, phase, variants, extra):
    """One layout rewrite on the routes ``variants`` names (variant →
    (route, the config fields it sets)): each through ``drive`` with its
    route's launch counts and gates (``rewrite_gates``), its distance from
    the route's own output, ms per frame off and on in turns (off, on, on,
    off), and whatever ``extra(cfg, cfg_on, cache, batch, off, on)``
    measures."""
    n_chunks = -(-N_CONTENT // MICROBATCH)
    cfg_f32, cache_f32, out_f32 = routes["f32_ns_pallas"]
    rows = {}
    batch = torch.as_tensor(content[:MICROBATCH], device=DEV)
    for variant, (route, fields) in variants.items():
        cfg, _, out_route = routes[route]
        cfg_on = dataclasses.replace(cfg, **fields)
        cache, out, counts, wall = drive(params, content, style, cfg_on)
        base = {**NO_LAUNCHES, "centered_gram": 5 * (1 + n_chunks),
                "ns_sqrtm": 5 * (1 + n_chunks) if cfg.method == "newton_schulz_pallas" else 0}
        row = rewrite_gates(params, content, f"{phase} {variant}", cfg_on, cache, out, counts, base,
                            out_f32, cache_f32, cfg_f32)
        d = (out - out_route).abs().flatten()
        row.update(launches=counts, first_run_wall_s=wall, batch1_vs_batch6_bitwise_equal=True,
                   vs_off_q99=float(torch.quantile(d[::3], 0.99)), vs_off_max=float(d.max()),
                   vs_off_bitwise_share=float((d == 0).float().mean()))
        off = lambda: cascade.stylize(params, batch, cache, ALPHA, cfg)  # noqa: E731
        on = lambda: cascade.stylize(params, batch, cache, ALPHA, cfg_on)  # noqa: E731
        t = [cuda_ms(fn, 3) / MICROBATCH for fn in (off, on, on, off)]
        row.update(ms_per_frame_b4=(t[1] + t[2]) / 2, ms_per_frame_b4_off=(t[0] + t[3]) / 2,
                   ms_per_frame_b4_turns_off_on_on_off=t, **extra(cfg, cfg_on, cache, batch, off, on))
        rows[variant] = row
    emit({"phase": phase, "card": card_name(), "size": SIZE, "n_images": N_CONTENT,
          "microbatch": MICROBATCH, "alpha": ALPHA, "routes": rows})


def fold_extra(params):
    """main_fold's own rows: the relu2_1 and relu1_1 decode stages
    (``fold_decode_ms``) and the gap of direct ``stylize`` between batch 1
    and batch 4 (printed, not gated: the folded conv's per-image weights
    make it depend on the submitted batch shape)."""
    def extra(cfg, cfg_on, cache, batch, off, on):
        one = cascade.stylize(params, batch[:1], cache, ALPHA, cfg_on)
        return {"direct_stylize_b1_vs_b4_max_abs": float((one[0] - on()[0]).abs().max()),
                "decode_stages_b4_ms": fold_decode_ms(params, batch, cache, cfg, cfg_on)}
    return extra


def ring_extra(params):
    """main_ring's own rows: the card's peak bytes of a batch-4 call each
    way, and per conv the share of interior elements equal bitwise to the
    padded conv's (printed, not gated: cuDNN may choose another algorithm
    for the SAME shape)."""
    def extra(cfg, cfg_on, cache, batch, off, on):
        return {"peak_bytes_b4_off": peak_bytes(off), "peak_bytes_b4": peak_bytes(on),
                "interior_bitwise_share_per_conv": ring_interior_shares(params, batch, cfg.dtype)}
    return extra


PACK2_VARIANTS = {
    "f32_ns_pallas": ("f32_ns_pallas", dict(pack2_junction=True)),
    "bf16_throughput": ("bf16_throughput", dict(pack2_junction=True)),
    "f32_tail_only": ("f32_ns_pallas", dict(pack2_junction=True, pack2_tail_only=True)),
    "f32_junction_only": ("f32_ns_pallas", dict(pack2_junction=True, pack2_junction_only=True)),
}
PACK2_FUNCTIONS = ("head_pack2", "head_pack2_shallow", "junction_pack2", "tail_pack2")


@contextlib.contextmanager
def pack2_calls():
    """Counts the calls the cascade makes into ``ops/pack2.py`` in the block:
    yields the dict it fills, one entry per function."""
    calls = dict.fromkeys(PACK2_FUNCTIONS, 0)
    plain = {name: getattr(pack2, name) for name in PACK2_FUNCTIONS}

    def counted(name):
        def fn(*args, **kw):
            calls[name] += 1
            return plain[name](*args, **kw)
        return fn

    for name in PACK2_FUNCTIONS:
        setattr(pack2, name, counted(name))
    try:
        yield calls
    finally:
        for name, fn in plain.items():
            setattr(pack2, name, fn)


def pack2_extra(params):
    """main_pack2's own rows: the calls one batch-4 ``stylize`` makes into
    ``ops/pack2.py`` (which parts the variant packs), the Gram kernel's
    launches in that call, and a batch of 3 (odd: the reference's gate
    leaves pack2 off) bitwise equal to the route without pack2."""
    def extra(cfg, cfg_on, cache, batch, off, on):
        reset_counts()
        with pack2_calls() as calls:
            on()
        torch.cuda.synchronize()
        grams = read_counts()["centered_gram"]
        check(grams == len(cfg.relu_targets), f"main_pack2: {grams} Gram launches in one call")
        check(calls["tail_pack2"] + calls["junction_pack2"] > 0, f"main_pack2: nothing packed {calls}")
        odd = batch[:3]
        check(torch.equal(cascade.stylize(params, odd, cache, ALPHA, cfg_on),
                          cascade.stylize(params, odd, cache, ALPHA, cfg)),
              "main_pack2: a batch of 3 differs from the route without pack2")
        return {"pack2_calls_b4": dict(calls), "centered_gram_launches_b4": grams,
                "odd_batch3_bitwise_equal_off": True}
    return extra


# The reference's bound of the int8 conv against the f32 conv
# (tests/test_convs.py:170-190): relative max < 0.02, on half-normal maps.
INT8_REL_LIMIT = 0.02


def int8_row(x, w, b) -> dict:
    """The int8 conv of ``x`` with OIHW ``w``, ``b``: its int32 sums against
    a float64 conv of the same quantized tensors on the card (must be
    bitwise equal), its output's relative max distance from the f32 conv,
    and the largest sum."""
    wq, ws = convs.quantize_weight_int8(w)
    xq, _ = convs.quantize_act_int8(convs.pad_reflect_nchw(x, 1))
    sums = convs.conv2d_int8_sums_nchw(xq, wq)
    exact = torch.equal(sums.double(), F.conv2d(xq.double(), wq.double()))
    y32 = conv2d_reflect_nchw(x, w, b)
    rel = float((convs.conv2d_reflect_int8_nchw(x, wq, ws, b) - y32).abs().max() / y32.abs().max())
    return {"sums_bitwise_equal_float64": exact, "vs_f32_rel_max": rel,
            "max_abs_sum": int(sums.abs().max())}


def phase_int8(params, content):
    """The int8 conv (``ops/convs.py``, ``wct_tpu/ops/convs.py:201-257``) at
    the cascade's shapes, batch 4 at 512 px, with the trained conv1_2 (on
    the relu1_1 map) and conv3_1 (on its input, the pooled relu2_2 map of
    the relu3_1 tier). On the cascade's own maps and on half-normal maps
    of the same shapes (the reference's test input,
    ``tests/test_convs.py:170-190``): the integer sums (``torch._int_mm`` on
    patches) bitwise equal to a float64 conv of the same quantized tensors
    on the card. The reference's bound against the f32 conv gates the
    half-normal maps; on the cascade's maps, whose per-tensor scale a few
    outliers set, the distance is printed. ms of the int8 conv, its sums
    alone, and the f32 and bf16 convs on the cascade's maps."""
    enc = params["encoder"]
    inputs, h = {}, to_nchw(torch.as_tensor(content[:MICROBATCH], device=DEV))
    gen = torch.Generator(device=DEV).manual_seed(SEED + 50)
    with torch.no_grad():
        for spec in vgg.ENCODER_LAYERS:
            if spec[0] == "pool":
                h = convs.maxpool2_nchw(h)
                continue
            if spec[1] in ("conv1_2", "conv3_1"):
                inputs[spec[1]] = h
            if spec[1] == "conv3_1":
                break
            p = enc[spec[1]]
            h = conv2d_reflect_nchw(h, p["w"], p["b"])
            h = torch.relu(h) if spec[0] == "conv" else h
        rows = {}
        for name, x in inputs.items():
            w, b = enc[name]["w"], enc[name]["b"]
            row = {"cascade_map": int8_row(x, w, b),
                   "half_normal_map": int8_row(
                       torch.randn(x.shape, generator=gen, device=DEV).abs(), w, b)}
            for kind, r in row.items():
                check(r["sums_bitwise_equal_float64"], f"int8 {name} {kind}: sums differ from float64")
            check(row["half_normal_map"]["vs_f32_rel_max"] < INT8_REL_LIMIT,
                  f"int8 {name}: {row['half_normal_map']} against the f32 conv")
            wq, ws = convs.quantize_weight_int8(w)
            xq, _ = convs.quantize_act_int8(convs.pad_reflect_nchw(x, 1))
            xb = x.bfloat16()
            row.update(
                cascade_map_max=float(x.max()), cascade_map_q99=float(torch.quantile(x.flatten()[::97], 0.99)),
                int8_ms=cuda_ms(lambda: convs.conv2d_reflect_int8_nchw(x, wq, ws, b), 3),
                int8_sums_ms=cuda_ms(lambda: convs.conv2d_int8_sums_nchw(xq, wq), 3),
                f32_ms=cuda_ms(lambda: conv2d_reflect_nchw(x, w, b), 3),
                bf16_ms=cuda_ms(lambda: conv2d_reflect_nchw(xb, w, b), 3))
            rows[f"{name} {list(x.shape)}->{w.shape[0]}"] = row
            del xq, xb
    emit({"phase": "int8", "card": card_name(), "size": SIZE, "batch": MICROBATCH, "convs": rows})


def ring_interior_shares(params, batch, dtype) -> dict:
    """Per conv of the encoder trunk to relu5_1, on the map the trunk
    hands it: the share of interior output elements (the p-pixel border
    left out) where the ring conv gives the padded conv's bits."""
    shares, x = {}, to_nchw(batch).to(dtype)
    with torch.no_grad():
        for spec in vgg.ENCODER_LAYERS:
            if spec[0] == "pool":
                x = convs.maxpool2_nchw(x)
                continue
            p = params["encoder"][spec[1]]
            y = conv2d_reflect_nchw(x, p["w"], p["b"])
            if spec[4] == 3:
                r = convs.conv2d_reflect_ring_nchw(x, p["w"], p["b"])
                key = f"{spec[1]} {list(x.shape)}->{spec[3]}"
                shares[key] = float((r[..., 1:-1, 1:-1] == y[..., 1:-1, 1:-1]).float().mean())
            x = torch.relu(y) if spec[0] == "conv" else y
    return shares


def peak_bytes(fn) -> int:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def per_level_files(work: Path) -> tuple[Path, list[Path], Path]:
    """``weights/bundle.npz`` as ``--vgg-path`` and ``--checkpoints`` take
    it: an encoder file and one decoder file per level (relu5_1 in the
    train-state form), then the bundle the port's ``make_bundle`` builds
    back from them, checked leaf for leaf against the shipped one (as
    loaded: its float16 leaves come back float32)."""
    work.mkdir(parents=True, exist_ok=True)
    tree = checkpoint.load_pytree(ROOT / "weights" / "bundle.npz")
    vgg_path = work / "vgg.npz"
    checkpoint.save_pytree(vgg_path, {"encoder": tree["encoder"]})
    ckpts = []
    for t in cascade.DEFAULT_TARGETS:
        ckpts.append(work / f"decoder_{t}.npz")
        dec = tree["decoders"][t]
        checkpoint.save_pytree(ckpts[-1], {"params": dec} if t == "relu5_1" else dec)
    rebuilt = work / "rebuilt.npz"
    cmd = [sys.executable, "-m", "wct_tpu_torch.tools.make_bundle", "--encoder", str(vgg_path),
           *[f"--decoder={t}={c}" for t, c in zip(cascade.DEFAULT_TARGETS, ckpts)], str(rebuilt)]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"make_bundle failed:\n{proc.stdout}\n{proc.stderr}")
    want, got = checkpoint._flatten(tree), checkpoint._flatten(checkpoint.load_pytree(rebuilt))
    check(want.keys() == got.keys() and all(
        want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]) for k in want),
        "the rebuilt bundle differs from weights/bundle.npz")
    return vgg_path, ckpts, rebuilt


def phase_cli():
    """The CLI as users run it: the two routes of earlier slices, then
    style-swap with luminance-only output and the style beside it, AdaIN
    over a blend of two styles, CORAL one pair at a time, ``--fold``, the
    throughput preset with ``--ring-conv``, and the trained weights as
    per-level files (``--checkpoints`` with ``--vgg-path``), which must
    write the bytes that ``--weights`` writes on the bundle ``make_bundle``
    rebuilds from those files."""
    work = ROOT / "build" / "chip_smoke"
    c_dir, s_dir, o_dir = work / "content", work / "styles", work / "out"
    for d in (c_dir, s_dir, o_dir):
        d.mkdir(parents=True, exist_ok=True)
        for f in d.iterdir():
            f.unlink()
    rng = np.random.default_rng(SEED + 1)
    for i in range(2):
        images.save_img(c_dir / f"c{i}.png", rng.random((300, 256, 3)))
    images.save_img(work / "style.png", rng.random((256, 320, 3)))
    images.save_img(s_dir / "s0.png", rng.random((256, 320, 3)))
    images.save_img(s_dir / "s1.png", rng.random((288, 256, 3)) * 0.5 + 0.3)
    one, two = work / "style.png", s_dir
    vgg_path, ckpts, rebuilt = per_level_files(work / "per_level")
    bundle = ["--weights", "weights/bundle.npz"]
    per_level = ["--vgg-path", str(vgg_path), "--checkpoints", *map(str, ckpts)]
    ns = ["--method", "newton_schulz_pallas"]
    runs = [  # flags, styles, outputs, their shape
        ([*bundle, *ns], one, 2, (300, 256, 3)),
        ([*bundle, "--preset", "throughput"], one, 2, (300, 256, 3)),
        ([*bundle, "--swap5", *ns, "--keep-colors", "--concat"], one, 2, (300, 256 + 300, 3)),
        ([*bundle, "--adain", "--interp-weights", "0.5", "0.5"], two, 2, (300, 256, 3)),
        ([*bundle, "--coral"], two, 4, (300, 256, 3)),
        ([*bundle, "--fold"], one, 2, (300, 256, 3)),
        ([*bundle, "--preset", "throughput", "--ring-conv"], one, 2, (300, 256, 3)),
        ([*per_level, *ns], one, 2, (300, 256, 3)),
        (["--weights", str(rebuilt), *ns], one, 2, (300, 256, 3)),
    ]
    written = []
    for flags, styles, n_out, shape in runs:
        for f in o_dir.iterdir():
            f.unlink()
        cmd = [sys.executable, "-m", "wct_tpu_torch.cli.stylize", *flags,
               "--content-path", str(c_dir), "--style-path", str(styles),
               "--out-path", str(o_dir), "--content-size", "256", "--batch-size", "2",
               "--alpha", str(ALPHA), "--device", DEV]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        check(proc.returncode == 0, f"CLI failed (rc {proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        outs = images.get_files(o_dir)
        check(len(outs) == n_out, f"CLI {flags} wrote {len(outs)} outputs, expected {n_out}")
        imgs = [images.get_img(p) for p in outs]
        check(all(i.shape == shape for i in imgs), f"CLI {flags} output shapes {[i.shape for i in imgs]}")
        check(all(np.isfinite(i).all() and i.std() > 0.01 for i in imgs), "CLI wrote a flat image")
        written.append([Path(p).read_bytes() for p in outs])
        emit({"phase": "cli", "flags": [str(Path(f).relative_to(ROOT)) if f.startswith(str(ROOT)) else f
                                        for f in flags], "seconds": secs,
              "outputs": [str(Path(p).relative_to(ROOT)) for p in outs]})
    check(written[-2] == written[-1],
          "--checkpoints/--vgg-path wrote other bytes than --weights on the rebuilt bundle")
    emit({"phase": "cli", "checkpoints_equal_weights_on_rebuilt_bundle": True,
          "rebuilt_bundle_equals_shipped_leaf_for_leaf": True})


# The stream's frame: the stream CLI's default size and BASELINE.json's
# fifth configuration (streaming 720p frames with a cached style).
STREAM_H, STREAM_W, STREAM_BATCH = 720, 1280, 4
N_STREAM = 24
# Launches per dispatch of the stream's routes.
PER_DISPATCH = {
    "bf16_fused": {"encoder_head_bf16": 1, "junction_bf16": 3, "decoder_tail_bf16": 1,
                   "centered_gram": 5},
    "f32_ns_pallas": {"ns_sqrtm": 5, "centered_gram": 5},
    "f32_eigh": {"centered_gram": 5},
}


def stream_frames(n: int, seed: int) -> list[np.ndarray]:
    """``n`` seeded noise frames at the stream's size; every sixth is
    540×960, which the engine resizes."""
    rng = np.random.default_rng(seed)
    return [rng.random((540, 960, 3) if i % 6 == 5 else (STREAM_H, STREAM_W, 3), dtype=np.float32)
            for i in range(n)]


def phase_stream_kernels(params, style, name):
    """Each kernel of the stream's routes at the stream's shapes, against its
    plain version with the gates of phase ``kernel``: the bf16 head,
    junctions and tail on one 720p batch of 4 and on its first frame alone,
    the dispatch of a ``frame_batch=1`` engine (the f32 route's maps rounded
    to bf16); the Gram on the five levels of that batch's bf16 features and
    of its f32 features (the f32 routes' ``encode_multi_nchw``), each at
    B = 4 and B = 1, and on a 1024² bucket's relu1_1 features (N = 921,600
    and 1,048,576, each against float64); and ns_sqrtm on the batch's and
    the style's covariances."""
    frames = np.stack(stream_frames(STREAM_BATCH, SEED + 10))
    cfg = cascade.CascadeConfig(method="newton_schulz_pallas")
    cache = cascade.precompute_style(params["encoder"], style, cfg)
    lines = phase_junction_kernels(params, frames, cache, cfg, name, dtypes=(torch.bfloat16,),
                                   main_case="stream_b4_720p", edge_cases=False,
                                   phase="stream_kernels")
    phase_junction_kernels(params, frames[:1], cache, cfg, name, dtypes=(torch.bfloat16,),
                           main_case="stream_b1_720p", edge_cases=False, phase="stream_kernels",
                           main=False)
    lines["ns_sqrtm"] = phase_kernel(params, frames, style, cfg, name, spd=False,
                                     phase="stream_kernels")
    del cache
    extra = []
    with torch.no_grad():
        x = to_nchw(torch.as_tensor(frames, device=DEV))
        for dtype in (torch.bfloat16, torch.float32):
            level_feats = vgg.encode_multi_nchw(params["encoder"], x.to(dtype), cfg.relu_targets)
            if dtype == torch.bfloat16:
                feats = level_feats
            tag = str(dtype).split(".")[-1]
            for level, f in level_feats.items():
                if dtype == torch.float32:
                    extra.append((f"{level}_b4_{tag}", f.flatten(2).contiguous()))
                extra.append((f"{level}_b1_{tag}", f[:1].flatten(2).contiguous()))
            del level_feats
        big = np.random.default_rng(SEED + 11).random((1, 1024, 1024, 3), dtype=np.float32)
        big = to_nchw(torch.as_tensor(big, device=DEV)).to(torch.bfloat16)
        f1024 = vgg.encode_multi_nchw(params["encoder"], big, ("relu1_1",))["relu1_1"]
    extra.append(("relu1_1_bucket_1024x1024_b1", f1024.flatten(2).contiguous()))
    lines.update(phase_gram_kernel({"feats": feats}, name, edge_cases=False,
                                   phase="stream_kernels", extra=extra))
    emit({"phase": "stream_kernels", "shape": [STREAM_BATCH, STREAM_H, STREAM_W, 3],
          "microbatch_lines": lines})


def stream_run(eng, frames, mode: str):
    """``frames`` through ``eng``, strict (``process`` each) or pipelined
    (``process_pipelined``, then the drain): (outputs, wall seconds); every
    output has been read back when it returns."""
    t0 = time.perf_counter()
    if mode == "strict":
        outs = [eng.process(f) for f in frames]
    else:
        outs = [o for o in (eng.process_pipelined(f) for f in frames) if o is not None]
        while (tail := eng.collect()) is not None:
            outs.append(tail)
    return outs, time.perf_counter() - t0


def same_bits(a, b) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def in_unit_range(outs) -> bool:
    return all(np.isfinite(o).all() and o.min() >= 0.0 and o.max() <= 1.0 for o in outs)


def stream_engine(params, cfg, style, frame_batch, readback="uint8"):
    """A started engine at the stream's size, its style set, warmed up by one
    pipelined group (the first dispatch of a shape times cuDNN per conv)."""
    eng = StreamStylizer(params, cfg, STREAM_H, STREAM_W, readback=readback,
                         frame_batch=frame_batch)
    eng.alpha = ALPHA
    eng.set_style(style)
    stream_run(eng, stream_frames(frame_batch, SEED + 12), "pipelined")
    return eng


def stream_route(params, cfg, style, frames, route, frame_batch=1, readback="uint8",
                 traced=False):
    """One engine on ``frames``: strict, then pipelined with the launch counts
    set to 0 just before and read just after, then a strict run of four
    frames under a StageTimer, the host time one cascade call takes to
    return against its whole time, and (``traced``) the card's busy share
    in a profiler trace of eight pipelined frames. Checks pipelined =
    strict bitwise, in order, nothing left pending, the launches per
    dispatch, outputs in [0, 1]. Returns (engine, strict outputs, pipelined
    outputs, row)."""
    eng = stream_engine(params, cfg, style, frame_batch, readback)
    strict, t_strict = stream_run(eng, frames, "strict")
    reset_counts()
    torch.cuda.synchronize()
    piped, t_piped = stream_run(eng, frames, "pipelined")
    counts = read_counts()
    dispatches = -(-len(frames) // frame_batch)
    expected = {**NO_LAUNCHES, **{k: v * dispatches for k, v in PER_DISPATCH[route].items()}}
    check(counts == expected, f"stream {route} fb{frame_batch}: launched {counts}, expected {expected}")
    check(same_bits(strict, piped), f"stream {route} fb{frame_batch}: pipelined differs from strict")
    check(eng.n_pending == 0, f"stream {route}: {eng.n_pending} frames left after the drain")
    check(in_unit_range(strict) and in_unit_range(piped), f"stream {route}: output not in [0, 1]")
    check(all(o.shape == (STREAM_H, STREAM_W, 3) for o in piped), f"stream {route}: output shape")
    eng.timer = StageTimer()
    stream_run(eng, frames[:4], "strict")
    split = {k: v * 1e3 / 4 for k, v in eng.timer.totals.items()}  # ms per strict frame
    eng.timer = None
    # Does the cascade call return before its work is done (is it enqueued
    # ahead of the card)? Host time to return against the whole call.
    x = torch.as_tensor(np.stack(frames[:frame_batch]), device=DEV)
    calls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cascade.stylize(params, x, eng._cache, ALPHA, cfg)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        calls.append((t1 - t0, time.perf_counter() - t0))
    enqueue_s, call_s = min(calls)
    del x
    strict_ms, piped_ms = t_strict * 1e3 / len(frames), t_piped * 1e3 / len(frames)
    around = sum(v for k, v in split.items() if k != "device")
    row = {"route": route, "frame_batch": frame_batch, "readback": readback, "n_frames": len(frames),
           "dispatches": dispatches, "launches": counts, "pipelined_equals_strict_bitwise": True,
           "strict_ms_per_frame": strict_ms, "pipelined_ms_per_frame": piped_ms,
           "pipelined_fps": len(frames) / t_piped, "strict_split_ms_per_frame": split,
           "hidden_ms_per_frame": strict_ms - piped_ms, "around_device_ms_per_frame": around,
           "cascade_enqueue_ms": enqueue_s * 1e3, "cascade_call_ms": call_s * 1e3}
    if traced:
        log_dir = ROOT / "build" / "chip_smoke" / f"trace_{route}_fb{frame_batch}"
        path = log_dir / "trace.json"
        path.unlink(missing_ok=True)
        with trace(str(log_dir)) as prof:
            check(prof is not None, f"stream {route}: the profiler did not start")
            stream_run(eng, frames[:8], "pipelined")
        row["traced_pipelined_device_busy_share"] = device_busy_share(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        per = -(-len(frames[:8]) // frame_batch)  # dispatches in the traced window
        row["traced_per_dispatch"] = {
            "kernels": sum(e.get("cat") == "kernel" for e in events) / per,
            "bmm_calls": sum(e.get("name") == "aten::bmm" for e in events) / per,
            "stream_synchronizes": sum(e.get("name") == "cudaStreamSynchronize" for e in events) / per,
        }
    return eng, strict, piped, row


def phase_stream(params, name):
    """StreamStylizer at 1280×720 on the trained bundle, one 512-px style:
    the bf16 fused route (frame_batch 1 and 4, uint8 and float32 readback, a
    live alpha change inside a group), then the f32 Newton–Schulz-kernel
    route on fewer frames and one group of frames on the eigh route."""
    style = np.random.default_rng(SEED + 13).random((SIZE, SIZE, 3), dtype=np.float32)
    frames = stream_frames(N_STREAM, SEED + 14)
    rows = []
    cfg = cascade.CascadeConfig(**BF16_FUSED)
    e1, s1, p1, row = stream_route(params, cfg, style, frames, "bf16_fused", traced=True)
    rows.append(row)
    e4, s4, p4, row = stream_route(params, cfg, style, frames, "bf16_fused", frame_batch=4,
                                   traced=True)
    # frame_batch=4 dispatches [4, 720, 1280, 3], a frame_batch=1 engine
    # [1, ...]; phase stream_batch_gap finds where the two part.
    gap = torch.as_tensor(np.abs(np.stack(p4) - np.stack(p1))).flatten()  # 66M values
    row["vs_frame_batch_1"] = {"median": float(gap.median()),
                               "q99": float(torch.quantile(gap[::8], 0.99)),
                               "max": float(gap.max()), "share_differing": float((gap > 0).float().mean())}
    check(row["vs_frame_batch_1"]["median"] < COMPOSED_MEDIAN_LIMIT,
          f"stream frame_batch 4 vs 1: {row['vs_frame_batch_1']}")
    rows.append(row)
    ef, _, pf, row = stream_route(params, cfg, style, frames[:8], "bf16_fused", readback="float32")
    del ef
    host_u8 = [(np.clip(o, 0, 1) * 255).astype(np.uint8) for o in pf]
    card_u8 = [e1.process(f, raw=True) for f in frames[:8]]  # the card's bytes
    check(same_bits(host_u8, card_u8), "uint8 readback differs from the host's quantisation")
    check(same_bits([b.astype(np.float32) / 255.0 for b in card_u8], p1[:8]),
          "uint8 readback: the float32 outputs are not the bytes / 255")
    row["uint8_readback_equals_host_quantisation_bitwise"] = True
    rows.append(row)
    del e1

    # A live alpha change between two submits of one group applies from the
    # next group on.
    e4.alpha = ALPHA
    e4.submit(frames[0])
    e4.alpha = 1.0
    for f in frames[1:8]:
        e4.submit(f)
    got = [e4.collect() for _ in range(8)]
    check(e4.collect() is None and e4.n_pending == 0, "alpha run left frames pending")
    want_next = [e4.process(f) for f in frames[4:8]]
    check(same_bits(got[:4], s4[:4]), "an alpha change applied to the group already started")
    check(same_bits(got[4:], want_next), "an alpha change did not apply from the next group")
    check(not same_bits(got[4:], s4[4:8]), "alpha 1.0 and alpha 0.6 outputs are the same")
    del e4

    cfg_ns = cascade.CascadeConfig(method="newton_schulz_pallas")
    for fb in (1, 4):
        eng, _, _, row = stream_route(params, cfg_ns, style, frames[:8], "f32_ns_pallas",
                                      frame_batch=fb, traced=fb == 1)
        rows.append(row)
        del eng
    eng, _, _, row = stream_route(params, cascade.CascadeConfig(), style, frames[:4], "f32_eigh",
                                  traced=True)
    rows.append(row)
    del eng
    emit({"phase": "stream", "size": [STREAM_H, STREAM_W], "style_size": SIZE, "alpha": ALPHA,
          "alpha_change_applies_from_next_group": True, "runs": rows,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})


# Allocations whose contents a kernel writes later: no result to compare.
_UNWRITTEN = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
              torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
              torch.ops.aten.new_empty_strided.default}


class op_prints(TorchDispatchMode):
    """Records each ATen op's name and an exact print of its tensor inputs
    (before it runs) and outputs: (shape, [Σ bits, Σ bits²]) over the first
    image where dim 0 is the batch of ``batch``, else over the whole
    tensor. The hand-written kernels are not ATen ops: their results show
    as inputs of the ops that read them."""

    def __init__(self, batch: int):
        super().__init__()
        self.batch, self.ops = batch, []

    def _print(self, t):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            return None
        if t.dim() and t.shape[0] == self.batch:
            t = t[:1]
        v = t.detach().reshape(-1)
        v = v.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[v.element_size()]
                   if v.dtype != torch.bool else torch.uint8).to(torch.int64)
        return tuple(t.shape), torch.stack([v.sum(), (v * v).sum()])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [self._print(a) for a in tree_leaves((args, kwargs))]
        out = func(*args, **kwargs)
        if func not in _UNWRITTEN:
            self.ops.append((str(func), ins, [self._print(o) for o in tree_leaves(out)]))
        return out


def first_batch_divergence(params, cfg, cache, x) -> dict:
    """Where the first image of ``x`` parts between the batch and itself
    alone: both cascade calls recorded by ``op_prints`` (after a warm-up
    call each, which times cuDNN for any new conv shape) and paired op by
    op: the runs' longest common runs of op names, in order.
    ``first_differing``: the first op with an output that differs;
    ``inputs_equal`` says whether that op made the difference (its inputs
    were equal), received it (from a hand-written kernel), or (None) had
    an input that cannot be paired. ``sources`` counts by name every op
    whose inputs were all equal and whose output was not."""
    runs = []
    for xb in (x, x[:1].contiguous()):
        cascade.stylize(params, xb, cache, ALPHA, cfg)
        torch.cuda.synchronize()
        with op_prints(len(xb)) as rec:
            cascade.stylize(params, xb, cache, ALPHA, cfg)
        runs.append([(name, [(p[0], p[1].tolist()) if p else None for p in ins],
                      [(p[0], p[1].tolist()) if p else None for p in outs])
                     for name, ins, outs in rec.ops])
        del rec
    batch, alone = runs

    def differs(a, b):
        return [x[1] != y[1] for x, y in zip(a, b) if x and y and x[0] == y[0]]

    def same(a, b):  # None where a tensor pair cannot be compared
        if len(a) != len(b) or any(bool(x) != bool(y) or x and x[0] != y[0] for x, y in zip(a, b)):
            return None
        return not any(differs(a, b))

    # Loops over the images add ops to the batch's run: pair the ops of the
    # longest common runs of names, in order.
    matcher = difflib.SequenceMatcher(None, [op[0] for op in batch], [op[0] for op in alone],
                                      autojunk=False)
    pairs = [(blk.a + k, blk.b + k) for blk in matcher.get_matching_blocks() for k in range(blk.size)]
    first, sources = None, Counter()
    for i, j in pairs:
        (name, ins, outs), (_, ins1, outs1) = batch[i], alone[j]
        if any(differs(outs, outs1)):
            inputs_equal = same(ins, ins1)
            if inputs_equal:
                sources[name] += 1
            if first is None:
                shape = next(p[0] for p in outs if p)
                first = {"index": i, "op": name, "output_shape": list(shape),
                         "inputs_equal": inputs_equal}
    return {"ops": [len(batch), len(alone)], "paired": len(pairs), "first_differing": first,
            "sources": dict(sources)}


def batch_gap(params, cfg, cache, x) -> dict:
    """The same frames ``x`` ([B, H, W, 3]) stylized as one batch and each
    alone (B = 1): the whole cascade's gap (median, q99, max, the share of
    values that differ) and each level's, teacher-forced on the batch's
    running image, as phase main_bf16_fused holds a level to f32."""

    def gap(c, xs):
        y = cascade.stylize(params, xs, cache, ALPHA, c)
        y1 = torch.cat([cascade.stylize(params, xs[i:i + 1], cache, ALPHA, c) for i in range(len(xs))])
        d = (y - y1).abs().flatten()
        return y, {"median": float(d.median()), "q99": float(torch.quantile(d[::4], 0.99)),
                   "max": float(d.max()), "share_differing": float((d > 0).float().mean())}

    _, whole = gap(cfg, x)
    levels = {}
    for level in cfg.relu_targets:
        x, levels[level] = gap(dataclasses.replace(cfg, relu_targets=(level,)), x)
    return {"whole": whole, "levels_teacher_forced": levels}


def phase_stream_batch_gap(params):
    """How far a 720p frame's output moves between a dispatch of four frames
    and a dispatch of it alone, on the bf16 fused stream route and on two
    witnesses (the unfused bf16 route and the f32 Newton–Schulz-kernel
    route), each held to main_bf16_fused's gates against f32 (the whole
    cascade's median, each level's q99), with the first op at which the
    two part and the ops that make the difference."""
    style = np.random.default_rng(SEED + 13).random((SIZE, SIZE, 3), dtype=np.float32)
    x = torch.as_tensor(np.stack(stream_frames(STREAM_BATCH, SEED + 14)), device=DEV)
    routes = {"bf16_fused": cascade.CascadeConfig(**BF16_FUSED),
              "bf16_unfused": cascade.CascadeConfig(**THROUGHPUT),
              "f32_ns_pallas": cascade.CascadeConfig(method="newton_schulz_pallas")}
    out = {}
    for route, cfg in routes.items():
        cache = cascade.precompute_style(params["encoder"], style, cfg)
        row = batch_gap(params, cfg, cache, x)
        row["divergence"] = first_batch_divergence(params, cfg, cache, x)
        check(row["whole"]["median"] < COMPOSED_MEDIAN_LIMIT
              and all(v["q99"] < LEVEL_Q99_LIMIT for v in row["levels_teacher_forced"].values()),
              f"{route}: batch 4 vs batch 1 {row}")
        out[route] = row
        del cache
    emit({"phase": "stream_batch_gap", "shape": list(x.shape), "alpha": ALPHA, "routes": out})


def phase_bucketed(params):
    """BucketedStylizer on the bf16 fused route at 300×256, 250×200,
    720×1280 and 1024×1024, then a second image in a bucket already seen:
    exact sizes, the fused kernels launched, no new conv shape timed for the
    seen bucket, and one output equal to ``stylize`` on the padded input."""
    cfg = cascade.CascadeConfig(**BF16_FUSED)
    eng = BucketedStylizer(params, cfg)
    rng = np.random.default_rng(SEED + 15)
    eng.set_style(rng.random((SIZE, SIZE, 3), dtype=np.float32))
    per_image = {**NO_LAUNCHES, **PER_DISPATCH["bf16_fused"]}
    rows = []
    for h, w in ((300, 256), (250, 200), (720, 1280), (1024, 1024), (270, 230)):
        img = rng.random((h, w, 3), dtype=np.float32)
        keys = set(convs._CUDNN_OK)
        seen = any(r["bucket"] == list(bucket_shape(h, w)) for r in rows)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.stylize(img, ALPHA)
        wall = time.perf_counter() - t0
        counts = read_counts()
        new_keys = len(set(convs._CUDNN_OK) - keys)
        check(out.shape == img.shape and np.isfinite(out).all(), f"bucketed {h}x{w}: {out.shape}")
        check(counts == per_image, f"bucketed {h}x{w} launched {counts}, expected {per_image}")
        check(not seen or new_keys == 0, f"bucketed {h}x{w}: a seen bucket timed {new_keys} new convs")
        t0 = time.perf_counter()
        eng.stylize(img, ALPHA)
        rows.append({"size": [h, w], "bucket": list(bucket_shape(h, w)), "seen_bucket": seen,
                     "first_call_s": wall, "new_conv_shapes": new_keys,
                     "warm_call_ms": (time.perf_counter() - t0) * 1e3, "launches": counts})
        if (h, w) == (720, 1280):
            padded, _ = pad_to_bucket(img, eng.granularity)
            ref = cascade.stylize(params, torch.as_tensor(padded, device=DEV)[None], eng._cache,
                                  ALPHA, cfg)[0, :h, :w].cpu().numpy()
            check(np.array_equal(out, ref), "bucketed output differs from stylize on the padded input")
    emit({"phase": "bucketed", "config": f"CascadeConfig({BF16_FUSED})", "granularity": eng.granularity,
          "alpha": ALPHA, "equals_stylize_on_padded_bitwise": True, "images": rows})


def phase_stream_cli():
    """The stream CLI's offline conversion as users run it: a seeded 1280×720
    mp4 of 16 frames through ``python -m wct_tpu_torch.cli.stream`` with the
    throughput preset in batches of 4, on the bundle and then on the
    per-level files of phase cli (``--checkpoints`` with ``--vgg-path``);
    every frame must be written."""
    import importlib.util

    if importlib.util.find_spec("cv2") is None:
        emit({"phase": "stream_cli", "skipped": "cv2 is not installed: no video IO"})
        return
    import cv2

    work = ROOT / "build" / "chip_smoke" / "stream"
    work.mkdir(parents=True, exist_ok=True)
    src, style = work / "in.mp4", work / "style.png"
    rng = np.random.default_rng(SEED + 16)
    writer = cv2.VideoWriter(str(src), cv2.VideoWriter_fourcc(*"mp4v"), 30, (STREAM_W, STREAM_H))
    for _ in range(16):
        writer.write((rng.random((STREAM_H, STREAM_W, 3)) * 255).astype(np.uint8))
    writer.release()
    images.save_img(style, rng.random((SIZE, SIZE, 3)))
    per_level = ROOT / "build" / "chip_smoke" / "per_level"
    ckpts = [str(per_level / f"decoder_{t}.npz") for t in cascade.DEFAULT_TARGETS]
    frames = {}
    for name, weights in (("weights", ["--weights", "weights/bundle.npz"]),
                          ("checkpoints", ["--vgg-path", str(per_level / "vgg.npz"),
                                           "--checkpoints", *ckpts])):
        out = work / f"out_{name}.mp4"
        out.unlink(missing_ok=True)
        cmd = [sys.executable, "-m", "wct_tpu_torch.cli.stream", *weights,
               "--video", str(src), "--out", str(out), "--no-display", "--batch-size", "4",
               "--preset", "throughput", "--style-path", str(style), "--alpha", str(ALPHA),
               "--width", str(STREAM_W), "--height", str(STREAM_H), "--device", DEV]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"stream CLI ({name}) failed (rc {proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        cap = cv2.VideoCapture(str(out))
        frames[name] = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames[name].append(frame)
        cap.release()
        shapes = [f.shape for f in frames[name]]
        check(len(shapes) == 16 and all(sh == (STREAM_H, STREAM_W, 3) for sh in shapes),
              f"stream CLI ({name}) wrote {len(shapes)} frames of {set(shapes)}, expected 16 of 720x1280")
        emit({"phase": "stream_cli", "weights": name, "cv2": cv2.__version__, "frames": len(shapes),
              "seconds": secs, "cli_says": proc.stdout.strip().splitlines()[-1]})
    emit({"phase": "stream_cli", "checkpoints_frames_equal_weights_frames": all(
        np.array_equal(a, b) for a, b in zip(frames["weights"], frames["checkpoints"]))})


# Decoder training at relu5_1, the deepest decoder (its feature term
# re-encodes through ten convs), with TrainConfig's defaults: batch 8,
# crop 256, f32, pixel and feature weights 1, lr 1e-4.
TRAIN_TARGET = "relu5_1"
TRAIN_STEPS = 30
TRAIN_POOL = 64
# First-step gradients, f32 against float64 of the same loss on the same
# batch, each leaf's relative Frobenius error. From He init the gradient
# is large and the bound is tight. At the bundle's trained decoder the
# gradient is a sum whose terms cancel by up to 10⁴, and a ReLU whose
# input sits within f32 rounding of 0 passes a term in one precision
# and blocks it in the other: a few such flips at a deep 32² layer move
# every leaf by about 1e-2 (an H100: 1.4e-2 under an earlier conv choice,
# 1.1e-3 under the present one; ``tools/train_precision`` splits it by
# route).
TRAIN_F64_HE_LIMIT = 5e-3
TRAIN_F64_LIMIT = 5e-2
# A bf16 first step: all gradients together (relative Frobenius) and the
# loss (relative), against f32 at the trained decoder and against float64
# from He init; 30 bf16 convs each round their sum once (an H100: 0.185
# and 2.9e-2 trained, 0.021 and 1.4e-2 from He init).
TRAIN_BF16_GRAD_LIMIT = 0.5
TRAIN_BF16_HE_GRAD_LIMIT = 0.1
TRAIN_BF16_LOSS_LIMIT = 5e-2
TRAIN_CONV_SLOWDOWN_LIMIT = 10.0
# Layerwise statistics over a pool of 16 images at the trainer's crop, in
# batches of 4; one batch's G in f32 against the same patches
# accumulated in float64 (TF32 would show as ≥ 1e-4).
LAYERWISE_G_LIMIT = 1e-4
LAYERWISE_SIZE = 256


def leaves(tree) -> dict:
    return {f"{n}/{k}": v for n, leaf in tree.items() for k, v in leaf.items()}


def fresh_params(tree, dtype=torch.float32) -> dict:
    """A copy of a decoder tree that requires gradients."""
    return {n: {k: v.detach().to(dtype).clone().requires_grad_(True) for k, v in leaf.items()}
            for n, leaf in tree.items()}


def first_grads(dec, enc, batch, cfg) -> tuple[float, dict]:
    params = fresh_params(dec)
    loss, _ = trainer.reconstruction_loss(params, enc, batch, cfg)
    loss.backward()
    return float(loss.detach()), {k: v.grad for k, v in leaves(params).items()}


def first_grads_f64(dec, enc, batch, target) -> tuple[float, dict]:
    """The same loss (pixel + feature, weights 1) in float64 on the card."""
    params = fresh_params(dec, torch.float64)
    enc64 = {n: {k: v.double() for k, v in leaf.items()} for n, leaf in enc.items()}
    x = to_nchw(batch.double() / 255.0)
    code = vgg.encode_multi_nchw(enc64, x, (target,))[target]
    decoded = decoder.decode_nchw(params, code, target)
    recode = vgg.encode_multi_nchw(enc64, decoded, (target,))[target]
    loss = (decoded - x).pow(2).mean() + (recode - code).pow(2).mean()
    loss.backward()
    return float(loss.detach()), {k: v.grad for k, v in leaves(params).items()}


def grad_rel(got: dict, ref: dict) -> dict:
    return {k: float((got[k].double() - ref[k].double()).norm() / ref[k].double().norm())
            for k in ref}


def global_rel(got: dict, ref: dict) -> float:
    diff = torch.cat([(got[k].double() - ref[k].double()).ravel() for k in ref])
    return float(diff.norm() / torch.cat([ref[k].double().ravel() for k in ref]).norm())


def same_state(a, b) -> bool:
    """Parameters and Adam moments of two TrainStates, bitwise."""
    fa, fb = checkpoint._flatten(trainer.state_tree(a)), checkpoint._flatten(trainer.state_tree(b))
    return sorted(fa) == sorted(fb) and all(np.array_equal(fa[k], fb[k]) for k in fa)


def conv_choices(batch: int) -> list:
    """The training convs' per-shape choices at ``batch``: the forward and
    backward ms of cuDNN and of PyTorch's own conv that the choices were
    made on, the implementation kept in each, and both timed again on fresh
    inputs (``check_*``), a measurement apart from the one the choice
    read."""
    rows = []
    for key, t in list(convs.CONV_TIMES.items()):
        x_shape, w_shape, dtype, _ = key
        if x_shape[0] != batch or dtype != torch.float32:
            continue
        x = torch.randn(x_shape, device=DEV)
        w = torch.randn(w_shape, device=DEV) / float(np.sqrt(np.prod(w_shape[1:])))
        again = convs._cudnn_ok_train(x, w, torch.zeros(w_shape[0], device=DEV))
        del x, w
        rows.append({"input": list(x_shape), "weight": list(w_shape),
                     **{k: v for k, v in t.items() if k.endswith("_ms")},
                     **{f"check_{k}": v for k, v in again.items() if k.endswith("_ms")},
                     **{f"{d}_chosen": "cudnn" if t[f"cudnn_{d}"] else "native"
                        for d in ("fwd", "bwd")}})
    return rows


def phase_train(params, name):
    """The relu5_1 decoder trained at full width on the trained bundle, its
    batches sampled on the card from a synthetic pool."""
    enc = params["encoder"]
    dec0 = params["decoders"][TRAIN_TARGET]
    cfg = trainer.TrainConfig(relu_target=TRAIN_TARGET)
    pool_np = tdata.synthetic_pool(np.random.default_rng(SEED + 20), TRAIN_POOL, cfg.crop_size)
    batches = tdata.device_pool_batches(pool_np, cfg.batch_size, seed=SEED, device=DEV)
    b0 = next(batches)
    check(b0.dtype == torch.uint8
          and tuple(b0.shape) == (cfg.batch_size, cfg.crop_size, cfg.crop_size, 3),
          f"pool batch {b0.dtype} {tuple(b0.shape)}")
    reset_counts()

    he = decoder.init_decoder_params(torch.Generator().manual_seed(SEED), TRAIN_TARGET, DEV)
    he_loss64, g64 = first_grads_f64(he, enc, b0, TRAIN_TARGET)
    he_loss32, g_he = first_grads(he, enc, b0, cfg)
    he_rel64 = grad_rel(g_he, g64)
    he_loss16, g_he = first_grads(he, enc, b0, dataclasses.replace(cfg, compute_dtype="bfloat16"))
    he_bf16_rel, he_bf16_loss_rel = global_rel(g_he, g64), abs(he_loss16 - he_loss64) / he_loss64
    check(max(he_rel64.values()) <= TRAIN_F64_HE_LIMIT,
          f"train: He-init f32 gradients vs float64 {max(he_rel64.values())}")
    check(abs(he_loss32 - he_loss64) <= 1e-5 * he_loss64,
          f"train: He-init f32 loss {he_loss32} vs float64 {he_loss64}")
    check(he_bf16_rel <= TRAIN_BF16_HE_GRAD_LIMIT and he_bf16_loss_rel <= TRAIN_BF16_LOSS_LIMIT,
          f"train: He-init bf16 vs float64 grads {he_bf16_rel}, loss {he_bf16_loss_rel}")
    del g64, g_he
    loss32, g32 = first_grads(dec0, enc, b0, cfg)
    loss64, g64 = first_grads_f64(dec0, enc, b0, TRAIN_TARGET)
    rel64 = grad_rel(g32, g64)
    check(max(rel64.values()) <= TRAIN_F64_LIMIT,
          f"train: f32 gradients vs float64 {max(rel64.values())} > {TRAIN_F64_LIMIT}")
    check(abs(loss32 - loss64) <= 1e-4 * loss64, f"train: f32 loss {loss32} vs float64 {loss64}")
    del g64
    _, g_again = first_grads(dec0, enc, b0, cfg)
    _, g_remat = first_grads(dec0, enc, b0, dataclasses.replace(cfg, remat=True))
    repeat_bits = all(torch.equal(g32[k], g_again[k]) for k in g32)
    remat_bits = all(torch.equal(g32[k], g_remat[k]) for k in g32)
    check(repeat_bits, "train: the same step twice gives other gradient bits")
    check(remat_bits, "train: remat=True changes the gradient bits")
    del g_again, g_remat
    loss16, g16 = first_grads(dec0, enc, b0, dataclasses.replace(cfg, compute_dtype="bfloat16"))
    bf16_rel, bf16_loss_rel = global_rel(g16, g32), abs(loss16 - loss32) / loss32
    check(bf16_rel <= TRAIN_BF16_GRAD_LIMIT and bf16_loss_rel <= TRAIN_BF16_LOSS_LIMIT,
          f"train: bf16 step vs f32 grads {bf16_rel}, loss {bf16_loss_rel}")
    del g16

    # 29 timed steps, a save, the 30th step; then the saved state resumed
    # and the 30th step again.
    state = trainer.train_state_from_params(fresh_params(dec0), cfg)
    batches = tdata.device_pool_batches(pool_np, cfg.batch_size, seed=SEED, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(TRAIN_STEPS - 1):
        state, m = trainer.train_step(state, enc, next(batches), cfg)
        losses.append(m["loss"])
    end.record()
    enqueue_s = time.perf_counter() - t0
    end.synchronize()
    loop_s = time.perf_counter() - t0
    step_ms = start.elapsed_time(end) / (TRAIN_STEPS - 1)
    peak = torch.cuda.max_memory_allocated()
    ckptr = checkpoint.TrainCheckpointer(ROOT / "build" / "chip_smoke" / "train_state")
    ckptr.save(state.step, trainer.state_tree(state))
    b_last = next(batches)
    state, m = trainer.train_step(state, enc, b_last, cfg)
    losses.append(m["loss"])
    resumed = trainer.restore_train_state(ckptr.restore_latest(), cfg, DEV)
    b_again = next(tdata.device_pool_batches(pool_np, cfg.batch_size, seed=SEED,
                                             start_step=resumed.step, device=DEV))
    check(torch.equal(b_again, b_last), "train: the pool's batch differs after a resume")
    resumed, _ = trainer.train_step(resumed, enc, b_again, cfg)
    resume_bits = same_state(state, resumed)
    check(resume_bits, "train: save, resume and one step differ from the uninterrupted step")
    losses = torch.stack(losses).tolist()
    check(all(np.isfinite(losses)), f"train: non-finite loss {losses}")
    steps_row = train_step_directories(enc, ckptr, cfg, pool_np)

    # One step at a time: the host's return against the card's time.
    host_ms, card_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        state, _ = trainer.train_step(state, enc, next(batches), cfg)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        card_ms.append(start.elapsed_time(end))
    kernel_launches = read_counts()

    # From He init at relu1_1 (lr 1e-3, as tests/test_trainer.py:24): the loss falls.
    cfg1 = trainer.TrainConfig(relu_target="relu1_1", learning_rate=1e-3)
    he = trainer.init_train_state(torch.Generator().manual_seed(SEED), cfg1, DEV)
    batches1 = tdata.device_pool_batches(pool_np, cfg1.batch_size, seed=SEED + 1, device=DEV)
    he_losses = []
    for _ in range(TRAIN_STEPS):
        he, m = trainer.train_step(he, enc, next(batches1), cfg1)
        he_losses.append(m["loss"])
    he_losses = torch.stack(he_losses).tolist()
    check(all(np.isfinite(he_losses)) and np.mean(he_losses[-5:]) < 0.75 * np.mean(he_losses[:5]),
          f"train: the relu1_1 loss from He init does not fall: {he_losses}")

    # The rule keeps cuDNN's forward unless it is more than 2× slower than
    # PyTorch's own conv, and the forward's implementation for the backward
    # unless it is more than 2× slower there. Timed again on fresh inputs,
    # no kept direction may be a pathological path, here more than 10×
    # slower than the other conv's (cuDNN's FFT path: about 200×, ROADMAP
    # queue 3).
    choices = conv_choices(cfg.batch_size)
    other = {"cudnn": "native", "native": "cudnn"}

    def rule_holds(r):
        fwd = "cudnn" if r["cudnn_fwd_ms"] <= 2.0 * r["native_fwd_ms"] else "native"
        bwd = other[fwd] if r[f"{fwd}_bwd_ms"] > 2.0 * r[f"{other[fwd]}_bwd_ms"] else fwd
        return (r["fwd_chosen"], r["bwd_chosen"]) == (fwd, bwd)

    check(all(rule_holds(r) for r in choices), "train: conv choice rule")
    slowest = max(r[f"check_{r[f'{d}_chosen']}_{d}_ms"]
                  / r[f"check_{other[r[f'{d}_chosen']]}_{d}_ms"]
                  for r in choices for d in ("fwd", "bwd"))
    check(slowest <= TRAIN_CONV_SLOWDOWN_LIMIT, f"train: a chosen conv direction {slowest}× slower")
    emit({"phase": "train", "card": card_name(), "target": TRAIN_TARGET,
          "config": dataclasses.asdict(cfg), "pool": TRAIN_POOL,
          "grad_vs_float64_rel": rel64, "grad_vs_float64_max": max(rel64.values()),
          "loss_f32": loss32, "loss_f64": loss64,
          "he_init_grad_vs_float64_max": max(he_rel64.values()),
          "he_init_loss_f32": he_loss32, "he_init_loss_f64": he_loss64,
          "he_init_bf16_grad_vs_float64": he_bf16_rel, "he_init_bf16_loss_rel": he_bf16_loss_rel,
          "repeat_same_bits": repeat_bits, "remat_same_bits": remat_bits,
          "bf16_grad_rel": bf16_rel, "bf16_loss_rel": bf16_loss_rel, "loss_bf16": loss16,
          "losses": losses, "resume_same_bits": resume_bits, "step_directories": steps_row,
          "ms_per_step": step_ms, "img_per_sec": cfg.batch_size * 1e3 / step_ms,
          "loop_host_enqueue_s": enqueue_s, "loop_s": loop_s,
          "max_memory_allocated_bytes": peak,
          "step_host_return_ms": host_ms, "step_card_ms": card_ms,
          "kernel_launches": kernel_launches,
          "he_init_relu1_1_losses": he_losses, "conv_shapes": choices,
          "chosen_direction_slowdown_max": slowest})


def train_step_directories(enc, ckptr, cfg, pool_np) -> dict:
    """The step-directory backend (``TrainCheckpointer(fmt="orbax")``): from
    the npz state ``ckptr`` holds, five steps saved with ``keep=3``; three
    directories remain, the highest restores bitwise, and one step from
    it is the step from the npz backend's restore of the same state."""
    work = ROOT / "build" / "chip_smoke" / "train_steps"
    shutil.rmtree(work, ignore_errors=True)
    steps = checkpoint.TrainCheckpointer(work, fmt="orbax", keep=3)
    npz = checkpoint.TrainCheckpointer(work / "npz")
    state = trainer.restore_train_state(ckptr.restore_latest(), cfg, DEV)
    batches = tdata.device_pool_batches(pool_np, cfg.batch_size, seed=SEED + 40, device=DEV)
    t0 = time.perf_counter()
    for _ in range(5):
        state, _ = trainer.train_step(state, enc, next(batches), cfg)
        steps.save(state.step, trainer.state_tree(state))
    save_s = time.perf_counter() - t0
    kept = steps.steps()
    check(kept == [state.step - 2, state.step - 1, state.step], f"train: step directories {kept}")
    restored = trainer.restore_train_state(steps.restore_latest(), cfg, DEV)
    check(same_state(restored, state), "train: the highest step directory does not restore bitwise")
    npz.save(state.step, trainer.state_tree(state))
    from_npz = trainer.restore_train_state(npz.restore_latest(), cfg, DEV)
    b = next(batches)
    restored, _ = trainer.train_step(restored, enc, b, cfg)
    from_npz, _ = trainer.train_step(from_npz, enc, b, cfg)
    check(same_state(restored, from_npz), "train: resume from a step directory differs from npz")
    return {"kept_steps": kept, "restore_bitwise": True, "resume_equals_npz_resume": True,
            "five_steps_and_saves_s": save_s}


def phase_train_layerwise(params):
    """Layerwise statistics at 256 px with subsample 4 (scripts/solve_layerwise.py:36),
    G against float64, and the solved relu1_1 decoder against He init."""
    enc = params["encoder"]
    pool_np = tdata.synthetic_pool(np.random.default_rng(SEED + 21), 16, LAYERWISE_SIZE)
    pool = torch.from_numpy(pool_np).to(DEV)
    specs = layerwise.regression_specs()
    stats = layerwise.init_stats(specs, DEV)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(0, len(pool), 4):
        layerwise.accumulate_stats(stats, enc, pool[i:i + 4], subsample=4)
    end.record()
    end.synchronize()
    pass_ms = start.elapsed_time(end) / (len(pool) // 4)

    # One batch in f32 against the same patches summed in float64.
    one = layerwise.accumulate_stats(layerwise.init_stats(specs, DEV), enc, pool[:4], subsample=4)
    acts = layerwise.encoder_trace(enc, pool[:4].float() / 255.0)
    g_rel, sym = {}, {}
    for s in specs:
        xin = acts[s["x_key"]]
        if s["x_pooled"]:
            xin = convs.upsample_nearest2(acts[s["pool_key"]])
        P = layerwise._patches(xin, s["k"])
        if s["x_c"] <= 64:
            P = P[::4]
        P = P.double()
        G64 = P.mT @ P
        G = one[s["dec"]]["G"]
        g_rel[s["dec"]] = float((G.double() - G64).norm() / G64.norm())
        sym[s["dec"]] = float((G - G.mT).abs().max() / G.abs().max())
        del P, G64
    check(max(g_rel.values()) <= LAYERWISE_G_LIMIT, f"layerwise G vs float64 {g_rel}")
    check(max(sym.values()) <= 1e-6, f"layerwise G not symmetric: {sym}")

    decoders = layerwise.solved_decoder_params(stats, verbose=False, device=DEV)
    held = np.stack([tdata.synthetic_image(np.random.default_rng(SEED + 99 + i), LAYERWISE_SIZE)
                     for i in range(4)])
    held = torch.from_numpy(held).to(DEV)

    def psnr(dec):
        with torch.no_grad():
            out = decoder.decode(dec, vgg.encode(enc, held, "relu1_1"), "relu1_1").clamp(0, 1)
        return float(10 * torch.log10(1.0 / (out - held).pow(2).mean()))

    solved = psnr(decoders["relu1_1"])
    he = psnr(decoder.init_decoder_params(torch.Generator().manual_seed(SEED), "relu1_1", DEV))
    check(solved > he + 10.0 and solved > 20.0, f"layerwise relu1_1 {solved} dB vs He init {he} dB")
    emit({"phase": "train_layerwise", "pool": list(pool.shape), "subsample": 4,
          "ms_per_batch_of_4": pass_ms, "G_vs_float64_rel": g_rel,
          "G_asymmetry_max": max(sym.values()), "G_exactly_symmetric":
              all(v == 0.0 for v in sym.values()),
          "psnr_solved_relu1_1_db": solved, "psnr_he_init_relu1_1_db": he})


def phase_train_cli():
    """The training CLI as users run it: 20 steps of the relu5_1 decoder on a
    device pool, a resume to 30, a SIGTERM mid-run and its resume, and the
    stylize CLI on the trained decoder."""
    import signal

    work = ROOT / "build" / "chip_smoke" / "train_cli"
    if work.exists():
        shutil.rmtree(work)
    ckpt, ckpt_sig = work / "ckpt", work / "ckpt_signal"
    base = [sys.executable, "-m", "wct_tpu_torch.cli.train", "--synthetic", "--synthetic-pool", "64",
            "--encoder-weights", "weights/bundle.npz", "--relu-target", TRAIN_TARGET,
            "--device", DEV]
    runs = []

    def run(args):
        t0 = time.perf_counter()
        proc = subprocess.run(base + args, cwd=ROOT, capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"train CLI {args} failed:\n{proc.stdout}\n{proc.stderr}")
        runs.append({"args": args, "seconds": time.perf_counter() - t0,
                     "cli_says": proc.stdout.strip().splitlines()[-2:]})

    def rows(d):
        return [json.loads(line) for line in (d / "metrics.jsonl").read_text().splitlines()]

    run(["--max-iter", "20", "--summary-iter", "10", "--save-iter", "20",
         "--checkpoint-dir", str(ckpt)])
    run(["--max-iter", "30", "--summary-iter", "10", "--save-iter", "20",
         "--checkpoint-dir", str(ckpt), "--resume"])
    steps = [r["step"] for r in rows(ckpt)]
    check(steps == [10, 20, 30], f"train CLI metrics steps {steps}")
    check(all(np.isfinite(r["loss"]) for r in rows(ckpt)), "train CLI: non-finite loss")
    state = checkpoint.load_pytree(ckpt / "state_latest.npz")
    check(int(state["step"]) == 30 and int(state["opt_state"][0][0]) == 30,
          "train CLI: state_latest.npz is not at step 30")

    t0 = time.perf_counter()
    proc = subprocess.Popen(base + ["--max-iter", "100000", "--summary-iter", "5",
                                    "--save-iter", "100000", "--checkpoint-dir", str(ckpt_sig)],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        metrics = ckpt_sig / "metrics.jsonl"
        while time.perf_counter() - t0 < 300 and not (metrics.exists() and metrics.read_text()):
            time.sleep(0.5)
            check(proc.poll() is None, "train CLI exited before SIGTERM")
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    check(proc.returncode == 0 and "checkpointing and stopping" in out,
          f"train CLI on SIGTERM (rc {proc.returncode}):\n{out}")
    stopped = int(checkpoint.load_pytree(ckpt_sig / "state_latest.npz")["step"])
    runs.append({"args": "SIGTERM after the first summary", "seconds": time.perf_counter() - t0,
                 "stopped_at": stopped})
    run(["--max-iter", str(stopped + 5), "--summary-iter", "1", "--save-iter", "100000",
         "--checkpoint-dir", str(ckpt_sig), "--resume"])
    after = rows(ckpt_sig)[-1]["step"]
    check(after == stopped + 5, f"train CLI resumed after SIGTERM to {after}, not {stopped + 5}")

    # The trained decoder in a bundle the stylize CLI reads.
    bundle = checkpoint.load_pytree(ROOT / "weights" / "bundle.npz")
    trained = work / "trained_bundle.npz"
    checkpoint.save_pytree(trained, {"encoder": bundle["encoder"], "decoders": {
        TRAIN_TARGET: checkpoint.load_pytree(ckpt / f"decoder_{TRAIN_TARGET}.npz")}})
    rng = np.random.default_rng(SEED + 22)
    images.save_img(work / "content.png", rng.random((256, 256, 3)))
    images.save_img(work / "style.png", rng.random((256, 256, 3)))
    out_dir = work / "out"
    cmd = [sys.executable, "-m", "wct_tpu_torch.cli.stylize", "--weights", str(trained),
           "--relu-targets", TRAIN_TARGET, "--content-path", str(work / "content.png"),
           "--style-path", str(work / "style.png"), "--out-path", str(out_dir), "--device", DEV]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"stylize CLI on the trained decoder:\n{proc.stdout}\n{proc.stderr}")
    [out] = images.get_files(out_dir)
    img = images.get_img(out)
    check(img.shape == (256, 256, 3) and np.isfinite(img).all() and img.std() > 0.01,
          f"stylize CLI on the trained decoder wrote {img.shape}")
    runs.append({"args": "stylize --relu-targets relu5_1 on the trained decoder",
                 "seconds": time.perf_counter() - t0})
    emit({"phase": "train_cli", "runs": runs, "metrics": rows(ckpt)})


# The mesh phases run on four shards of cuda:0 (and, where there is more
# than one card, on a mesh of every card as well). BASELINE.json's fourth
# configuration: batch-8 1024-px content, a fixed style, data-parallel.
MESH_SHARDS = 4
MESH_DP_SIZE, MESH_DP_BATCH = 1024, 8
MESH_SPATIAL_SIZE = 2048
# The halo encoder against the unsharded one, q99 of |Δ| over the map's
# max; the per-level teacher-forced output, q99 of |Δ|.
MESH_ENCODER_Q99, MESH_LEVEL_Q99 = 1e-5, 5e-3


def meshes(axis_name="data") -> dict:
    """Four shards of cuda:0, and every card where there is more than one."""
    out = {"4_shards_cuda0": mesh_lib.create_mesh(MESH_SHARDS, axis_name, device="cuda:0")}
    if torch.cuda.device_count() > 1:
        out["all_cards"] = mesh_lib.create_mesh(axis_name=axis_name)
    return out


def in_turns(a, b, runs=2) -> tuple[float, float]:
    """ms of ``a`` and of ``b`` timed in turns (a, b, b, a), CUDA events on
    the current stream."""
    ta, tb = [], []
    for fn, acc in ((a, ta), (b, tb), (b, tb), (a, ta)):
        acc.append(cuda_ms(fn, iters=runs, warmup=0))
    return float(np.mean(ta)), float(np.mean(tb))


def gap(got, ref) -> dict:
    d = (got - ref).abs().flatten()
    return {"median": float(d.median()), "q99": float(torch.quantile(d[::7].float(), 0.99)),
            "max": float(d.max()), "share_differing": float((d > 0).float().mean())}


def counted_per_shard(fn):
    """``fn()`` with the kernels' launches counted around each shard's
    ``cascade.stylize`` call (``parallel.stylize_sharded`` calls it once per
    shard): (result, [{kernel: launches}, ...])."""
    rows, plain = [], cascade.stylize

    def counted(*args, **kw):
        before = read_counts()
        out = plain(*args, **kw)
        after = read_counts()
        rows.append({k: after[k] - before[k] for k in ("ns_sqrtm", "centered_gram")})
        return out

    cascade.stylize = counted
    try:
        return fn(), rows
    finally:
        cascade.stylize = plain


def phase_mesh_dp(params, style):
    """Data-parallel stylization of 8 seeded 1024-px images (BASELINE
    config 4) on the trained bundle, f32 with the Newton–Schulz kernel and
    in the bf16 throughput configuration: each shard bitwise equal to
    ``stylize`` of its two images, the batch held to unsharded batch 8 by
    the stream's gates, launches per shard, ms per frame in turns."""
    x = torch.as_tensor(np.random.default_rng(SEED + 30).random(
        (MESH_DP_BATCH, MESH_DP_SIZE, MESH_DP_SIZE, 3), dtype=np.float32), device=DEV)
    routes = {"f32_ns_pallas": cascade.CascadeConfig(method="newton_schulz_pallas"),
              "bf16_throughput": cascade.CascadeConfig(**THROUGHPUT)}
    rows = {}
    for mesh_name, mesh in meshes().items():
        for route, cfg in routes.items():
            cache = cascade.precompute_style(params["encoder"], style, cfg)
            reset_counts()
            torch.cuda.synchronize()
            out, per_shard = counted_per_shard(
                lambda: mesh_lib.stylize_sharded(params, x, cache, ALPHA, cfg, mesh))
            torch.cuda.synchronize()
            counts = read_counts()
            n_levels, per = len(cfg.relu_targets), MESH_DP_BATCH // len(mesh.devices)
            want = {"ns_sqrtm": n_levels if cfg.method == "newton_schulz_pallas" else 0,
                    "centered_gram": n_levels}
            check(per_shard == [want] * len(mesh.devices),
                  f"mesh_dp {route}: launches per shard {per_shard}, expected {want}")
            check(counts == {**NO_LAUNCHES, **{k: v * len(mesh.devices) for k, v in want.items()}},
                  f"mesh_dp {route}: launches {counts}")
            check(tuple(out.shape) == tuple(x.shape) and bool(torch.isfinite(out).all()),
                  f"mesh_dp {route}: output {tuple(out.shape)}")
            for i, dev in enumerate(mesh.devices):
                ref = cascade.stylize(mesh_lib.replicate(mesh, params, dev),
                                      x[i * per:(i + 1) * per].to(dev),
                                      mesh_lib.replicate(mesh, cache, dev), ALPHA, cfg)
                check(torch.equal(out[i * per:(i + 1) * per], ref.to(out.device)),
                      f"mesh_dp {route}: shard {i} differs from stylize of its images")
            whole = cascade.stylize(params, x, cache, ALPHA, cfg)
            row = {"launches_per_shard": per_shard, "launches": counts,
                   "shards_equal_stylize_bitwise": True, "vs_batch8_whole": gap(out, whole)}
            levels, xl = {}, x
            for level in cfg.relu_targets:
                one = dataclasses.replace(cfg, relu_targets=(level,))
                ref = cascade.stylize(params, xl, cache, ALPHA, one)
                levels[level] = gap(mesh_lib.stylize_sharded(params, xl, cache, ALPHA, one, mesh), ref)
                xl = ref
            row["vs_batch8_levels_teacher_forced"] = levels
            del xl, ref, whole
            check(row["vs_batch8_whole"]["median"] < COMPOSED_MEDIAN_LIMIT
                  and all(v["q99"] < LEVEL_Q99_LIMIT for v in levels.values()),
                  f"mesh_dp {route}: sharded vs batch 8 {row}")
            ms_b8, ms_sh = in_turns(lambda: cascade.stylize(params, x, cache, ALPHA, cfg),
                                    lambda: mesh_lib.stylize_sharded(params, x, cache, ALPHA, cfg, mesh))
            row.update({"ms_per_frame_unsharded_b8": ms_b8 / MESH_DP_BATCH,
                        "ms_per_frame_sharded": ms_sh / MESH_DP_BATCH,
                        "shard_enqueue_vs_device_ms": shard_times(mesh)})
            rows[f"{mesh_name}/{route}"] = row
            del out, cache
        rows[f"{mesh_name}/f32_ns_pallas_pack2"] = mesh_dp_pack2(params, style, x, mesh)
        rows[f"{mesh_name}/eigh_c512"] = mesh_eigh(mesh)
    emit({"phase": "mesh_dp", "card": card_name(), "batch": MESH_DP_BATCH, "size": MESH_DP_SIZE,
          "alpha": ALPHA, "shards": MESH_SHARDS, "runs": rows})


def mesh_eigh(mesh) -> dict:
    """The eigh kernel at C = 512 (a cluster of 16 blocks, a non-portable
    size) on every card of ``mesh``, the first card first: each card's
    result bitwise the first's, no matrix at the sweep cap."""
    cards = list(dict.fromkeys(mesh.devices))
    a = seeded_spd(MICROBATCH, 512, SEED + 31)
    s0, u0 = eigh_ops.eigh_cuda(a.to(cards[0]))
    for dev in cards[1:]:
        s, u = eigh_ops.eigh_cuda(a.to(dev))
        check(torch.equal(s.to(s0.device), s0) and torch.equal(u.to(u0.device), u0),
              f"mesh eigh: {dev} differs from {cards[0]}")
    capped = {str(d): eigh_ops.capped_sweeps(d) for d in cards}
    check(not any(capped.values()), f"mesh eigh: matrices at the sweep cap {capped}")
    return {"cards": [str(d) for d in cards], "bitwise_equal_first_card": True, "capped_sweeps": capped}


def mesh_dp_pack2(params, style, x, mesh) -> dict:
    """``stylize_sharded`` with pack2 on the f32 Newton–Schulz-kernel route.
    A batch that divides the mesh: every shard packs its own pairs and is
    bitwise ``stylize`` of its images with pack2; ms per frame against
    pack2 off in turns. A batch that does not (2n − 1 on n shards): pack2
    off on every shard, bitwise the call without it."""
    n = len(mesh.devices)
    cfg = cascade.CascadeConfig(method="newton_schulz_pallas", pack2_junction=True)
    off = dataclasses.replace(cfg, pack2_junction=False)
    cache = cascade.precompute_style(params["encoder"], style, cfg)
    row = {}
    if len(x) % n == 0:
        with pack2_calls() as calls:
            out = mesh_lib.stylize_sharded(params, x, cache, ALPHA, cfg, mesh)
        per = len(x) // n
        check(calls["tail_pack2"] == (n if per % 2 == 0 else 0), f"mesh_dp pack2: calls {calls}")
        for i, dev in enumerate(mesh.devices):
            ref = cascade.stylize(mesh_lib.replicate(mesh, params, dev), x[i * per:(i + 1) * per].to(dev),
                                  mesh_lib.replicate(mesh, cache, dev), ALPHA, cfg)
            check(torch.equal(out[i * per:(i + 1) * per], ref.to(out.device)),
                  f"mesh_dp pack2: shard {i} differs from stylize of its images")
        ms_off, ms_on = in_turns(lambda: mesh_lib.stylize_sharded(params, x, cache, ALPHA, off, mesh),
                                 lambda: mesh_lib.stylize_sharded(params, x, cache, ALPHA, cfg, mesh))
        row.update(dividing_batch=len(x), pack2_calls=dict(calls), shards_equal_stylize_bitwise=True,
                   ms_per_frame_sharded_pack2=ms_on / len(x), ms_per_frame_sharded_off=ms_off / len(x))
        del out, ref
    odd = x[: 2 * n - 1]
    with pack2_calls() as calls:
        on = mesh_lib.stylize_sharded(params, odd, cache, ALPHA, cfg, mesh)
    check(not any(calls.values()) and torch.equal(
        on, mesh_lib.stylize_sharded(params, odd, cache, ALPHA, off, mesh)),
        f"mesh_dp pack2: a batch of {len(odd)} on {n} shards is not the call without pack2")
    row.update(non_dividing_batch=len(odd), non_dividing_bitwise_equal_off=True)
    return row


def phase_mesh_spatial(params, style):
    """One 2048×2048 image split by height over four shards, on the WCT
    route (f32, Newton–Schulz kernel) and on AdaIN: the halo encoder to
    relu5_1 against the unsharded one, the combined covariances against
    float64 at every level, the output per level teacher-forced against
    the unsharded cascade, launches, ms in turns and peak memory."""
    img = torch.as_tensor(np.random.default_rng(SEED + 31).random(
        (1, MESH_SPATIAL_SIZE, MESH_SPATIAL_SIZE, 3), dtype=np.float32), device=DEV)
    enc = params["encoder"]
    rows = {}
    for mesh_name, mesh in meshes("sp").items():
        n = len(mesh.devices)
        feats = mesh_lib.encode_spatial(enc, img, "relu5_1", mesh)
        ref = vgg.encode(enc, img, "relu5_1")
        d = (feats - ref.to(feats.device)).abs().flatten()
        enc_row = {"q99_rel": float(torch.quantile(d[::3], 0.99) / ref.abs().max()),
                   "max_rel": float(d.max() / ref.abs().max()),
                   "bitwise_share": float((d == 0).float().mean())}
        check(enc_row["q99_rel"] <= MESH_ENCODER_Q99, f"mesh_spatial: halo encoder {enc_row}")
        del feats, ref, d
        covs = {}
        for level in cascade.DEFAULT_TARGETS:
            # The level's map split as the cascade splits it: blocks of
            # 16 image rows.
            f = mesh_lib.encode_spatial(enc, img, level, mesh)
            split = mesh_lib.shard_spatial(f, mesh, "sp", block=16 // vgg.TARGET_SCALE[level])
            cov, _ = mesh_lib.sharded_covariance(mesh, [to_nchw(p) for p in split.shards])
            x64 = to_nchw(f).flatten(2).double()
            c64 = x64 - x64.mean(-1, keepdim=True)
            covs[level] = rel_fro(cov.double(), (c64 @ c64.mT) / (x64.shape[-1] - 1))
            del f, split, x64, c64
        check(max(covs.values()) <= GRAM_F64_LIMIT, f"mesh_spatial: covariances vs float64 {covs}")
        routes = {"wct_f32_ns_pallas": cascade.CascadeConfig(method="newton_schulz_pallas"),
                  "adain_f32": cascade.CascadeConfig(transform="adain")}
        for route, cfg in routes.items():
            cache = cascade.precompute_style(enc, style, cfg)
            reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = mesh_lib.stylize_spatial(params, img, cache, ALPHA, cfg, mesh)
            torch.cuda.synchronize()
            peak_sp = torch.cuda.max_memory_allocated()
            counts = read_counts()
            want = {"ns_sqrtm": 5 if cfg.transform == "wct" else 0, "centered_gram": 5 * n}
            check(counts == {**NO_LAUNCHES, **want}, f"mesh_spatial {route}: launches {counts}")
            check(tuple(out.shape) == tuple(img.shape) and bool(torch.isfinite(out).all()),
                  f"mesh_spatial {route}: output {tuple(out.shape)}")
            again = mesh_lib.stylize_spatial(params, img, cache, ALPHA, cfg, mesh)
            check(torch.equal(out, again), f"mesh_spatial {route}: two calls differ")
            del again
            torch.cuda.reset_peak_memory_stats()
            whole = cascade.stylize(params, img, cache, ALPHA, cfg)
            torch.cuda.synchronize()
            peak_un = torch.cuda.max_memory_allocated()
            row = {"launches": counts, "deterministic": True, "vs_unsharded_whole": gap(out, whole),
                   "card_peak_bytes_all_shards": peak_sp, "card_peak_bytes_unsharded": peak_un,
                   "card_peak_bytes_all_shards_over_shards": peak_sp / n}
            levels, xl = {}, img
            for level in cfg.relu_targets:
                one = dataclasses.replace(cfg, relu_targets=(level,))
                ref = cascade.stylize(params, xl, cache, ALPHA, one)
                levels[level] = gap(mesh_lib.stylize_spatial(params, xl, cache, ALPHA, one, mesh), ref)
                xl = ref
            del xl, ref, whole
            row["vs_unsharded_levels_teacher_forced"] = levels
            check(all(v["q99"] <= MESH_LEVEL_Q99 for v in levels.values()),
                  f"mesh_spatial {route}: per-level q99 {levels}")
            ms_un, ms_sp = in_turns(lambda: cascade.stylize(params, img, cache, ALPHA, cfg),
                                    lambda: mesh_lib.stylize_spatial(params, img, cache, ALPHA, cfg, mesh),
                                    runs=1)
            row.update({"ms_unsharded": ms_un, "ms_spatial": ms_sp})
            rows[f"{mesh_name}/{route}"] = row
            del out, cache
        rows[f"{mesh_name}/encoder_relu5_1"] = enc_row
        rows[f"{mesh_name}/covariance_vs_float64_rel_fro"] = covs
        rows[f"{mesh_name}/wct_f32_ns_pallas_rewrites"] = mesh_spatial_rewrites(params, style, img, mesh)
    emit({"phase": "mesh_spatial", "card": card_name(), "size": MESH_SPATIAL_SIZE,
          "alpha": ALPHA, "shards": MESH_SHARDS, "runs": rows})


def mesh_spatial_rewrites(params, style, img, mesh) -> dict:
    """``stylize_spatial`` of the phase's image on the f32
    Newton–Schulz-kernel route with ``fold_transform`` and with
    ``ring_conv``, each against the same call without the flag (q99 ≤
    REWRITE_Q99_LIMIT, ms in turns), and with pack2 on the one image
    (odd: the reference's gate leaves it off), bitwise the call without."""
    cfg = cascade.CascadeConfig(method="newton_schulz_pallas")
    cache = cascade.precompute_style(params["encoder"], style, cfg)
    base = mesh_lib.stylize_spatial(params, img, cache, ALPHA, cfg, mesh)
    row = {}
    for field in ("fold_transform", "ring_conv"):
        on_cfg = dataclasses.replace(cfg, **{field: True})
        reset_counts()
        on = mesh_lib.stylize_spatial(params, img, cache, ALPHA, on_cfg, mesh)
        torch.cuda.synchronize()
        counts = read_counts()
        g = gap(on, base)
        check(bool(torch.isfinite(on).all()) and g["q99"] <= REWRITE_Q99_LIMIT,
              f"mesh_spatial {field}: against the call without it {g}")
        ms_off, ms_on = in_turns(lambda: mesh_lib.stylize_spatial(params, img, cache, ALPHA, cfg, mesh),
                                 lambda: mesh_lib.stylize_spatial(params, img, cache, ALPHA, on_cfg, mesh),
                                 runs=1)
        row[field] = {"vs_off": g, "launches": counts, "ms": ms_on, "ms_off": ms_off}
        del on
    packed = mesh_lib.stylize_spatial(params, img, cache, ALPHA,
                                      dataclasses.replace(cfg, pack2_junction=True), mesh)
    check(torch.equal(packed, base), "mesh_spatial: pack2 on one image is not the call without it")
    row["pack2_one_image_bitwise_equal_off"] = True
    del base, packed
    row["mesh_spatial_pack2"] = mesh_spatial_pack2(params, style, img, mesh)
    return row


@contextlib.contextmanager
def conv_weight_shapes():
    """Records ``[Co, Ci, k, k]`` of every conv run in the block: the
    cascade's (``convs.conv2d_valid_nchw``, which ``conv2d_reflect_nchw``
    calls) and ``stylize_spatial``'s (``parallel.mesh``'s own binding of
    it for the halo convs; its 1×1 convs go through
    ``conv2d_reflect_nchw``). Yields the Counter it fills."""
    shapes, plain = Counter(), convs.conv2d_valid_nchw

    def recorded(x, w, b):
        shapes[tuple(w.shape)] += 1
        return plain(x, w, b)

    convs.conv2d_valid_nchw = mesh_lib.conv2d_valid_nchw = recorded
    try:
        yield shapes
    finally:
        convs.conv2d_valid_nchw = mesh_lib.conv2d_valid_nchw = plain


MESH_PACK2_ROUTES = {
    "f32_ns_pallas_pack2": dict(method="newton_schulz_pallas", pack2_junction=True),
    "f32_ns_pallas_tail_only": dict(method="newton_schulz_pallas", pack2_junction=True,
                                    pack2_tail_only=True),
    "f32_ns_pallas_junction_only": dict(method="newton_schulz_pallas", pack2_junction=True,
                                        pack2_junction_only=True),
    "bf16_throughput_pack2": dict(THROUGHPUT, pack2_junction=True),
}


def mesh_spatial_pack2(params, style, img, mesh) -> dict:
    """``stylize_spatial`` with pack2 on an even batch: the phase's image
    and a second seeded one, on the f32 Newton–Schulz-kernel route in each
    pack2 scope and on the bf16 throughput route. Each against the same
    call without pack2: q99 ≤ REWRITE_Q99_LIMIT, finite, the same launches
    (5 ``ns_sqrtm`` on the f32 route, 5 Grams a shard), two calls bitwise
    equal; the conv weight shapes the walk runs, over the shard count, are
    the ones the unsharded cascade runs with the config (a 64-px batch of
    two: the shapes do not depend on the size); ms on and off in turns,
    card peak bytes of each.

    A call of two 2048² images leaves 70–84 GB reserved by the caching
    allocator, pack2 on or off: each shard's stream frees its blocks only
    once the card has passed them, and the host runs ahead. Near the
    card's 80 GiB a call frees every cached block and allocates again (a
    retry: on "NVIDIA H100 80GB HBM3, 700.00 W" one took a 1014-ms call to
    1732 ms, ``tools/spatial_pack2_turns``), so the row records the
    retries its turns met: its ms compare on and off only where that
    count is 0."""
    n = len(mesh.devices)
    second = torch.as_tensor(np.random.default_rng(SEED + 32).random(
        tuple(img.shape), dtype=np.float32), device=DEV)
    pair = torch.cat([img, second])
    small = pair[:, :64, :64]
    rows, offs = {}, {}
    for route, kw in MESH_PACK2_ROUTES.items():
        cfg = cascade.CascadeConfig(**kw)
        cfg_off = dataclasses.replace(cfg, pack2_junction=False, pack2_tail_only=False,
                                      pack2_junction_only=False)
        cache = cascade.precompute_style(params["encoder"], style, cfg)
        run_on = lambda: mesh_lib.stylize_spatial(params, pair, cache, ALPHA, cfg, mesh)  # noqa: E731
        run_off = lambda: mesh_lib.stylize_spatial(params, pair, cache, ALPHA, cfg_off, mesh)  # noqa: E731
        if cfg_off not in offs:  # the first call at these shapes chooses their convs
            reset_counts()
            off = run_off()
            torch.cuda.synchronize()
            offs[cfg_off] = (off, read_counts(), peak_bytes(run_off))
        off, counts_off, peak_off = offs[cfg_off]
        reset_counts()
        with conv_weight_shapes() as spatial:
            on = run_on()
        torch.cuda.synchronize()
        counts = read_counts()
        want = {"ns_sqrtm": 5 if cfg.method == "newton_schulz_pallas" else 0, "centered_gram": 5 * n}
        check(counts == counts_off == {**NO_LAUNCHES, **want},
              f"mesh_spatial_pack2 {route}: launches {counts}, pack2 off {counts_off}")
        with conv_weight_shapes() as unsharded:
            cascade.stylize(params, small, cache, ALPHA, cfg)
        plan = mesh_lib.pack2_plan(cfg, len(pair))
        check(spatial == Counter({k: n * v for k, v in unsharded.items()}),
              f"mesh_spatial_pack2 {route}: conv shapes {dict(spatial)}, unsharded {dict(unsharded)}")
        check(any(6 in shape[:2] for shape in spatial) and any(plan.encoder),
              f"mesh_spatial_pack2 {route}: nothing packed {plan}")
        g = gap(on, off)
        check(tuple(on.shape) == tuple(pair.shape) and bool(torch.isfinite(on).all())
              and g["q99"] <= REWRITE_Q99_LIMIT,
              f"mesh_spatial_pack2 {route}: against pack2 off {g}")
        peak_on = peak_bytes(lambda: check(torch.equal(run_on(), on),
                                           f"mesh_spatial_pack2 {route}: two calls differ"))
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        ms_off, ms_on = in_turns(run_off, run_on, runs=1)
        rows[route] = {"plan": dataclasses.asdict(plan), "launches": counts, "vs_off": g,
                       "deterministic": True, "conv_shapes_as_unsharded": True,
                       "ms": ms_on, "ms_off": ms_off, "card_peak_bytes": peak_on,
                       "card_peak_bytes_off": peak_off,
                       "alloc_retries_in_turns":
                           torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries}
        del on, cache
    return {"batch": len(pair), "routes": rows}


def phase_ring_2048(params, style):
    """mesh_spatial's unsharded 2048×2048 image, f32 with the Newton–Schulz
    kernel, padded and with ``ring_conv``: ms in turns, the card's peak
    bytes of the ring's first call (which chooses its SAME convs), of the
    whole cascade and of each level alone (teacher-forced on the padded
    route's running image), and the ring's distance from the padded output
    (q99 ≤ REWRITE_Q99_LIMIT)."""
    img = torch.as_tensor(np.random.default_rng(SEED + 31).random(
        (1, MESH_SPATIAL_SIZE, MESH_SPATIAL_SIZE, 3), dtype=np.float32), device=DEV)
    cfg = cascade.CascadeConfig(method="newton_schulz_pallas")
    cfg_ring = dataclasses.replace(cfg, ring_conv=True)
    caches = {c: cascade.precompute_style(params["encoder"], style, c) for c in (cfg, cfg_ring)}
    run = {c: (lambda c=c: cascade.stylize(params, img, caches[c], ALPHA, c)) for c in (cfg, cfg_ring)}
    out = run[cfg]()
    # The ring's first call meets its SAME shapes for the first time, so
    # conv_by_shape times both implementations of each inside it.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out_ring = run[cfg_ring]()
    torch.cuda.synchronize()
    row = {"peak_bytes_ring_first_call": torch.cuda.max_memory_allocated(),
           "vs_padded": gap(out_ring, out)}
    check(row["vs_padded"]["q99"] <= REWRITE_Q99_LIMIT, f"ring_2048 vs padded {row}")
    del out, out_ring
    row["ms_padded"], row["ms_ring"] = in_turns(run[cfg], run[cfg_ring], runs=1)
    row["peak_bytes_padded"], row["peak_bytes_ring"] = peak_bytes(run[cfg]), peak_bytes(run[cfg_ring])
    levels, x = {}, img
    for level in cfg.relu_targets:
        one = {c: dataclasses.replace(c, relu_targets=(level,)) for c in (cfg, cfg_ring)}
        levels[level] = {
            "peak_bytes_padded": peak_bytes(lambda: cascade.stylize(params, x, caches[cfg], ALPHA, one[cfg])),
            "peak_bytes_ring": peak_bytes(
                lambda: cascade.stylize(params, x, caches[cfg_ring], ALPHA, one[cfg_ring]))}
        x = cascade.stylize(params, x, caches[cfg], ALPHA, one[cfg])
    row["levels_alone"] = levels
    emit({"phase": "ring_2048", "card": card_name(), "size": MESH_SPATIAL_SIZE, "alpha": ALPHA,
          "config": "CascadeConfig(method='newton_schulz_pallas'), ring_conv off and on", **row})


def by_hand_step_grads(tree, enc, batch, cfg, n) -> list:
    """The four-shard step's all-reduce written out once more: each of
    ``n`` ``tensor_split`` shards' gradients, weighted by b_s/B and summed
    in shard order, in the optimizer's parameter order."""
    total = None
    for part in torch.tensor_split(batch, n):
        params = fresh_params(tree)
        loss, _ = trainer.reconstruction_loss(params, enc, part, cfg)
        g = list(torch.autograd.grad(loss, checkpoint.tree_leaves(params)))
        torch._foreach_mul_(g, part.shape[0] / batch.shape[0])
        if total is None:
            total = g
        else:
            torch._foreach_add_(total, g)
    return total


def phase_mesh_train(params):
    """The train phase's shape (relu5_1, batch 8, crop 256): a mesh of one
    equals ``train_step`` bitwise over two steps; four shards' first-step
    gradients equal their all-reduce written out by hand, bitwise, and are
    held to float64 by the bars ``train`` holds ``train_step`` to, beside
    their distance from ``train_step``'s (whose batch-8 convs round
    otherwise than the shards' batch-2 ones); ms per step in turns."""
    enc, dec0 = params["encoder"], params["decoders"][TRAIN_TARGET]
    cfg = trainer.TrainConfig(relu_target=TRAIN_TARGET)
    pool_np = tdata.synthetic_pool(np.random.default_rng(SEED + 32), TRAIN_POOL, cfg.crop_size)

    def batches():
        return tdata.device_pool_batches(pool_np, cfg.batch_size, seed=SEED, device=DEV)

    def state(tree=dec0):
        return trainer.train_state_from_params(fresh_params(tree), cfg)

    def step_grads(s) -> dict:
        return {f"{n}/{k}": v.grad for n, leaf in s.params.items() for k, v in leaf.items()}

    one = mesh_lib.create_mesh(1, device="cuda:0")
    a, b = state(), state()
    step1 = trainer.make_sharded_train_step(one, cfg)
    for batch, _ in zip(batches(), range(2)):
        a, _ = step1(a, enc, batch)
        b, _ = trainer.train_step(b, enc, batch, cfg)
    check(same_state(a, b), "mesh_train: a mesh of one differs from train_step")
    rows = {"one_entry_equals_train_step_bitwise": True}
    he = decoder.init_decoder_params(torch.Generator().manual_seed(SEED), TRAIN_TARGET, DEV)
    for mesh_name, mesh in meshes().items():
        step = trainer.make_sharded_train_step(mesh, cfg)
        b0 = next(batches())
        for start, tree, limit in (("trained", dec0, TRAIN_F64_LIMIT),
                                   ("he_init", he, TRAIN_F64_HE_LIMIT)):
            s_sh, m_sh = step(state(tree), enc, b0)
            s_un, m_un = trainer.train_step(state(tree), enc, b0, cfg)
            g_sh, g_un = step_grads(s_sh), step_grads(s_un)
            hand = by_hand_step_grads(tree, enc, b0, cfg, len(mesh.devices))
            same = all(torch.equal(x, y.to(x.device)) for x, y in zip(g_sh.values(), hand))
            _, g64 = first_grads_f64(tree, enc, b0, TRAIN_TARGET)
            row = {"equals_all_reduce_by_hand_bitwise": same,
                   "vs_train_step_grad_rel_fro": global_rel(g_sh, g_un),
                   "vs_train_step_grad_rel_fro_leaf_max": max(grad_rel(g_sh, g_un).values()),
                   "vs_train_step_loss_rel": abs(float(m_sh["loss"]) - float(m_un["loss"]))
                   / float(m_un["loss"]),
                   "sharded_vs_float64_leaf_max": max(grad_rel(g_sh, g64).values()),
                   "train_step_vs_float64_leaf_max": max(grad_rel(g_un, g64).values())}
            rows[f"{mesh_name}/{start}"] = row
            check(same, f"mesh_train {mesh_name} {start}: gradients differ from the all-reduce by hand")
            check(row["sharded_vs_float64_leaf_max"] <= limit,
                  f"mesh_train {mesh_name} {start}: sharded gradients vs float64 {row}")
            del s_sh, s_un, g_sh, g_un, hand, g64
        s_sh, s_un = state(), state()
        it = batches()
        ms_un, ms_sh = in_turns(lambda: trainer.train_step(s_un, enc, next(it), cfg),
                                lambda: step(s_sh, enc, next(it)), runs=3)
        rows[f"{mesh_name}/times"] = {"ms_per_step_unsharded": ms_un, "ms_per_step_sharded": ms_sh,
                                      "img_per_sec_unsharded": cfg.batch_size * 1e3 / ms_un,
                                      "img_per_sec_sharded": cfg.batch_size * 1e3 / ms_sh}
    emit({"phase": "mesh_train", "card": card_name(), "target": TRAIN_TARGET,
          "batch": cfg.batch_size, "crop": cfg.crop_size, "shards": MESH_SHARDS, "runs": rows})


def phase_mesh_cli():
    """``--data-parallel`` through both CLIs, as users run them: the stylize
    CLI with and without the flag, each its own process, and the plain run
    again in a third; the same two runs in this process; and the train CLI
    for four steps. Every process takes its conv choices from the one
    choice file (``ops/convs.py``), so two processes of the plain run write
    the same bits, and on one card (a mesh of one) so do all four runs."""
    from wct_tpu_torch.cli import stylize as stylize_cli

    work = ROOT / "build" / "chip_smoke" / "mesh_cli"
    if work.exists():
        shutil.rmtree(work)
    c_dir = work / "content"
    c_dir.mkdir(parents=True)
    rng = np.random.default_rng(SEED + 33)
    n_dev = torch.cuda.device_count()
    for i in range(2 * n_dev):
        images.save_img(c_dir / f"c{i}.png", rng.random((256, 320, 3)))
    images.save_img(work / "style.png", rng.random((256, 256, 3)))
    runs, outs = [], {}

    def argv(out, extra):
        return ["--weights", "weights/bundle.npz", "--method", "newton_schulz_pallas",
                "--content-path", str(c_dir), "--style-path", str(work / "style.png"),
                "--out-path", str(work / out), "--batch-size", str(2 * n_dev),
                "--alpha", str(ALPHA), "--device", DEV, *extra]

    for name, extra in (("data_parallel", ["--data-parallel"]), ("plain", []),
                        ("plain_again", [])):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "wct_tpu_torch.cli.stylize", *argv(name, extra)],
                              cwd=ROOT, capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"stylize CLI {extra}:\n{proc.stdout}\n{proc.stderr}")
        outs[name] = images.get_files(work / name)
        runs.append({"cli": "stylize", "args": extra, "seconds": time.perf_counter() - t0,
                     "cli_says": proc.stdout.strip().splitlines()[-1]})
        if name == "plain_again":
            continue
        with contextlib.redirect_stdout(io.StringIO()):
            stylize_cli.main(argv(f"{name}_in_process", extra))
        outs[f"{name}_in_process"] = images.get_files(work / f"{name}_in_process")
    names = {k: [Path(p).name for p in v] for k, v in outs.items()}
    check(len(names["plain"]) == 2 * n_dev and all(v == names["plain"] for v in names.values()),
          f"stylize CLI outputs {names}")

    def max_diff(a, b):
        return max(float(np.abs(images.get_img(x) - images.get_img(y)).max())
                   for x, y in zip(outs[a], outs[b]))

    def same_files(a, b):
        return all(Path(x).read_bytes() == Path(y).read_bytes() for x, y in zip(outs[a], outs[b]))

    same = same_files("plain_in_process", "data_parallel_in_process")
    check(same or n_dev > 1, "stylize CLI --data-parallel on one card, in one process, wrote other files")
    two_processes = same_files("plain", "plain_again")
    check(two_processes, "two processes of the stylize CLI wrote other files")
    across = max_diff("plain", "data_parallel")
    check(across == 0.0 or n_dev > 1,
          f"stylize CLI processes with and without --data-parallel on one card differ by {across}")
    check(across <= FUSED_MAX_LIMIT, f"stylize CLI with and without --data-parallel differ by {across}")
    cmd = [sys.executable, "-m", "wct_tpu_torch.cli.train", "--synthetic", "--synthetic-pool", "16",
           "--encoder-weights", "weights/bundle.npz", "--relu-target", "relu3_1",
           "--batch-size", str(2 * n_dev), "--crop-size", "128", "--max-iter", "4",
           "--summary-iter", "2", "--save-iter", "4", "--checkpoint-dir", str(work / "ckpt"),
           "--device", DEV, "--data-parallel"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"train CLI --data-parallel:\n{proc.stdout}\n{proc.stderr}")
    steps = [json.loads(line)["step"] for line in (work / "ckpt" / "metrics.jsonl").read_text().splitlines()]
    check(steps == [2, 4], f"train CLI --data-parallel steps {steps}")
    runs.append({"cli": "train", "args": ["--data-parallel"], "seconds": time.perf_counter() - t0,
                 "cli_says": proc.stdout.strip().splitlines()[-2:]})
    emit({"phase": "mesh_cli", "card": card_name(), "cards": n_dev, "in_process_same_files": same,
          "two_processes_same_files": two_processes, "across_processes_max_abs": across,
          "subprocess_vs_in_process_max_abs": max_diff("plain", "plain_in_process"), "runs": runs})


def main() -> int:
    name = phase_device()
    phase_build()
    params = checkpoint.params_from_numpy(
        checkpoint.load_pytree(ROOT / "weights" / "bundle.npz"), DEV
    )
    rng = np.random.default_rng(SEED)
    content = rng.random((N_CONTENT, SIZE, SIZE, 3)).astype(np.float32)
    style = rng.random((SIZE, SIZE, 3)).astype(np.float32)
    cfg = cascade.CascadeConfig(method="newton_schulz_pallas")
    cfg_fused = cascade.CascadeConfig(method="newton_schulz_pallas", fuse_junction=True)
    lines = {"ns_sqrtm": phase_kernel(params, content, style, cfg, name)}
    cache = cascade.precompute_style(params["encoder"], style, cfg)
    lines.update(phase_junction_kernels(params, content, cache, cfg, name))
    phase_junction_stages(params, content, cache, cfg)
    _, out_unfused = phase_main(params, content, style, cfg)
    counts = phase_main_fused(params, content, style, cfg_fused, out_unfused, cache, cfg)
    cfg_bf16 = cascade.CascadeConfig(**THROUGHPUT)
    cache_bf16 = cascade.precompute_style(params["encoder"], style, cfg_bf16)
    tensors = throughput_path_tensors(params, content, cache_bf16, cfg_bf16)
    lines.update(phase_conv_small_kernels(params, tensors, name))
    lines.update(phase_gram_kernel(tensors, name))
    del tensors
    counts_bf16, out_bf16, cache_bf16 = phase_main_bf16(params, content, style, cfg_bf16,
                                                        out_unfused, cache, cfg)
    counts.update({k: counts_bf16[k] for k in ("conv3x3_small", "conv3x3_small_nchw")})
    counts_bf16_fused = phase_main_bf16_fused(
        params, content, style, cascade.CascadeConfig(**BF16_FUSED), out_unfused, cache, cfg,
        out_bf16, cache_bf16, cfg_bf16)
    counts.update({f"{k}_bf16": counts_bf16_fused[f"{k}_bf16"] for k in BY_DTYPE})
    phase_main_eigh(params, content, style, cache, cfg)
    lines["eigh_jacobi"] = phase_eigh_kernel(params, content, style, name)
    counts["eigh_jacobi"] = lines["eigh_jacobi"]["launches"]
    out_adain, cache_adain, cfg_adain = phase_main_adain(params, content, style)
    phase_main_adain_fused(params, content, style, out_adain, cache_adain, cfg_adain)
    phase_main_swap5(params, content, style, cache, cfg)
    phase_main_groups(params, content, style, name)
    phase_main_trunc(params, content, style)
    routes = {"f32_ns_pallas": (cfg, cache, out_unfused),
              "bf16_throughput": (cfg_bf16, cache_bf16, out_bf16)}
    phase_rewrite(params, content, style, routes, "main_fold", on_both_routes(fold_transform=True),
                  fold_extra(params))
    phase_rewrite(params, content, style, routes, "main_ring", on_both_routes(ring_conv=True),
                  ring_extra(params))
    phase_rewrite(params, content, style, routes, "main_pack2", PACK2_VARIANTS, pack2_extra(params))
    del routes
    phase_int8(params, content)
    phase_cli()
    phase_stream_kernels(params, style, name)
    phase_stream(params, name)
    phase_stream_batch_gap(params)
    phase_bucketed(params)
    phase_stream_cli()
    phase_train(params, name)
    phase_train_layerwise(params)
    phase_train_cli()
    phase_mesh_dp(params, style)
    phase_mesh_spatial(params, style)
    phase_ring_2048(params, style)
    phase_mesh_train(params)
    phase_mesh_cli()
    small = "wct_tpu_torch/csrc/conv3x3_small.cu"
    head = ("wct_tpu_torch/csrc/encoder_head.cu", "wct_tpu/ops/junction_pallas.py:368")
    tail = ("wct_tpu_torch/csrc/decoder_tail.cu", "wct_tpu/ops/junction_pallas.py:467")
    junc = ("wct_tpu_torch/csrc/junction.cu", "wct_tpu/ops/junction_pallas.py:530")
    meta = {
        "ns_sqrtm": ("wct_tpu_torch/csrc/ns_sqrtm.cu", "wct_tpu/ops/sqrtm.py:169"),
        "encoder_head": head,
        "encoder_head_bf16": head,
        "decoder_tail": tail,
        "decoder_tail_bf16": tail,
        "junction": junc,
        "junction_bf16": junc,
        "conv3x3_small": (small, "wct_tpu/ops/conv_pallas.py:144, scripts/exp_nchw_conv.py:158"),
        "conv3x3_small_nchw": (small, "scripts/exp_nchw_conv.py:74"),
        "centered_gram": ("wct_tpu_torch/csrc/centered_gram.cu", "wct_tpu/ops/gram_pallas.py:109"),
        "eigh_jacobi": ("wct_tpu_torch/csrc/eigh_jacobi.cu", "none: XLA's eigh (wct_tpu/ops/wct.py)"),
    }
    # ms, plain_ms, bound_ms and library_ms are one microbatch's calls (5
    # ns_sqrtm, 1 head, 3 junctions, 1 tail in each operand type; the four
    # trained small convs at [4, ·, 512, 512] through each entry; the five
    # levels' Grams; the five levels' eigh, its launches those of an f32
    # microbatch of the default route). Launches are the fused main paths' runs (main_fused for
    # the f32 forms, main_bf16_fused for the bf16 ones) and, for the small
    # conv (NHWC entry, NCHW entry), main_bf16's entry-point calls.
    print(json.dumps({"kernels": [{
        "name": k, "route": "cuda", "source": src, "replaces": repl, "launches": counts[k],
        "max_abs_err": lines[k]["max_abs_err"], "ms": lines[k]["ms"],
        "plain_ms": lines[k]["plain_ms"], "bound_ms": lines[k]["bound_ms"],
        "bound_by": lines[k]["bound_by"], "library_ms": lines[k].get("library_ms"),
    } for k, (src, repl) in meta.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
