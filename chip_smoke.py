#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100. It
builds every CUDA kernel of the port from ``wct_tpu_torch/csrc``, holds
each against its plain PyTorch version at the main path's shapes (and
at awkward ones), runs the five-level relu5_1 → relu1_1 cascade at
512 px on the trained ``weights/bundle.npz`` through
``precompute_style`` and ``stylize_microbatched`` twice, unfused
(``CascadeConfig(method="newton_schulz_pallas")``) and with
``fuse_junction=True``, checks the outputs of each and one against the
other, and runs the CLI once.

Each phase prints one JSON line. The line before the last lists each
kernel with its launches in the main path's run and its times; the
last line is ``{"ok": true, "device": {...}}``. Any failed check
raises, so the script exits non-zero and prints no last line; so it
does without a CUDA device or outside a checkout.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from wct_tpu_torch.models import cascade, decoder, vgg
from wct_tpu_torch.ops import _build, junction, sqrtm
from wct_tpu_torch.ops import wct as wct_ops
from wct_tpu_torch.ops.convs import to_nchw
from wct_tpu_torch.train import checkpoint
from wct_tpu_torch.utils import images
from wct_tpu_torch.utils.device import cuda_ms

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


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def peaks(name: str) -> tuple[float, float]:
    return _PEAK_PCIE if "PCIe" in name else _PEAK_SXM


def ns_bound_ms(batch: int, c: int, iters: int, flops: float, bw: float) -> tuple[float, str]:
    """Least time for one Newton–Schulz call: max(ops/peak, bytes/bandwidth)."""
    ops = batch * 2 * iters * 3 * c**3  # wct_tpu/ops/sqrtm.py:208
    nbytes = batch * c * c * 4 * 3  # read A, write both outputs
    t_ops, t_bytes = ops / flops * 1e3, nbytes / bw * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


KERNEL_WRAPPERS = {
    "ns_sqrtm": sqrtm.ns_sqrtm_cuda,
    "encoder_head": junction.encoder_head_cuda,
    "junction": junction.junction_cuda,
    "decoder_tail": junction.decoder_tail_cuda,
}


def reset_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0], flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    return name


def phase_build():
    t0 = time.perf_counter()
    libs = _build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in lib.with_name(lib.name + ".log").read_text().splitlines()
               if "registers" in ln or "spill" in ln]
        for name, lib in libs.items()
    }
    emit({"phase": "build", "seconds": secs, "libraries": [str(p.relative_to(ROOT)) for p in libs.values()],
          "ptxas": ptxas})


def level_covariances(params, content, cfg):
    """The covariances the main path hands the kernel: each level's
    content Grams (+eps·I) for one microbatch, from the trained encoder."""

    x = to_nchw(torch.as_tensor(content[:MICROBATCH], device=DEV))
    covs = {}
    with torch.no_grad():
        feats = vgg.encode_multi_nchw(params["encoder"], x, cfg.relu_targets)
        for level in cfg.relu_targets:
            cov, _ = wct_ops._gram_cn(feats[level].flatten(2))
            eye = torch.eye(cov.shape[-1], device=cov.device)
            covs[level] = (cov + wct_ops.DEFAULT_EPS * eye).contiguous()
    return covs


def phase_kernel(params, content, cfg, name):
    """ns_sqrtm against its plain version at the main path's shapes."""

    flops, bw = peaks(name)
    iters, reg = sqrtm.DEFAULT_ITERS, sqrtm.DEFAULT_REG
    kernel = lambda a: sqrtm.ns_sqrtm_cuda(a, iters, reg)  # noqa: E731
    plain = lambda a: sqrtm._ns_plain(a, iters, reg)  # noqa: E731
    rows = []
    cases = [(lvl, a) for lvl, a in level_covariances(params, content, cfg).items()]
    gen = torch.Generator().manual_seed(SEED)
    for c in (64, 128, 256, 512):  # random SPD at B=16, condition number 100
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
        n = 20 if c <= 256 else 10
        ms_k, ms_p = cuda_ms(lambda: kernel(a), n), cuda_ms(lambda: plain(a), n)
        bound, bound_by = ns_bound_ms(b, c, iters, flops, bw)
        row = {"phase": "kernel", "kernel": "ns_sqrtm", "case": label, "B": b, "C": c,
               "rel_err_sqrt": err_sq, "rel_err_isqrt": err_isq, "max_abs_err": max_abs,
               "sqrt_isqrt_minus_I_fro": inv_err, "ms": ms_k, "plain_ms": ms_p,
               "bound_ms": bound, "bound_by": bound_by}
        emit(row)
        check(err_sq <= 1e-4 and err_isq <= 1e-4,
              f"ns_sqrtm vs plain at {label}: rel err {err_sq:.2e}, {err_isq:.2e} > 1e-4")
        rows.append(row)
    # The kernel's line: one microbatch's five content levels.
    main_rows = [r for r in rows if r["case"] in cfg.relu_targets]
    return {
        "ms": sum(r["ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": sum(r["bound_ms"] for r in main_rows),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in main_rows) else "bytes",
        "max_abs_err": max(r["max_abs_err"] for r in main_rows),
    }


def phase_main(params, content, style, cfg):
    # The main path's run: style once, then two microbatches (the
    # second padded). Only this window's launches count.
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = cascade.precompute_style(params["encoder"], style, cfg)
    out = cascade.stylize_microbatched(params, content, cache, ALPHA, cfg, microbatch=MICROBATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["ns_sqrtm"]
    n_levels = len(cfg.relu_targets)
    n_chunks = -(-N_CONTENT // MICROBATCH)
    check(counts == {"ns_sqrtm": n_levels * (1 + n_chunks), "encoder_head": 0, "junction": 0,
                     "decoder_tail": 0}, f"unfused main path launched {counts}")
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

    # Where one microbatch's time goes, stage by stage (teacher-forced on
    # the running image, as the cascade runs them).
    stages = {}
    with torch.no_grad():
        x = to_nchw(batch)
        for level in cfg.relu_targets:
            enc = lambda: vgg.encode_multi_nchw(params["encoder"], x, (level,))[level]  # noqa: E731
            feats = enc()
            wct = lambda: cascade._transform_level(feats, level, cache[level], ALPHA, cfg)  # noqa: E731
            tr = wct()
            dec = lambda: decoder.decode_nchw(params["decoders"][level], tr, level)  # noqa: E731
            stages[level] = {"encode_ms": cuda_ms(enc, runs), "wct_ms": cuda_ms(wct, runs),
                             "decode_ms": cuda_ms(dec, runs)}
            x = dec()
    emit({"phase": "main", "config": "CascadeConfig(method='newton_schulz_pallas')",
          "size": SIZE, "n_images": N_CONTENT, "microbatch": MICROBATCH, "alpha": ALPHA,
          "ns_sqrtm_launches": launches, "first_run_wall_s": wall,
          "alpha0_vs_alpha1_mean_abs": a_diff, "batch1_vs_batch6_bitwise_equal": True,
          "vs_plain_q99": q99, "vs_plain_max": dmax, "ms_per_frame_b4": ms_frame,
          "ms_per_frame_b4_plain_ns": ms_frame_plain, "precompute_style_ms": ms_style,
          "stages_b4_ms": stages,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    return launches, out


# Kernel against plain: f32 sums of up to 576 terms taken in another order,
# through up to four convs with conv0's O(255) weights in the third. Limit on
# max |Δ| relative to the map's largest value (measured ≤ 2e-5).
JUNCTION_LIMIT = 1e-4
# Fused cascade against unfused cascade of the same run: the limits the CPU
# tests hold the two routes to (five levels of whitening amplify the
# kernels' rounding differences ≈100×).
FUSED_Q99_LIMIT, FUSED_MAX_LIMIT = 5e-3, 3e-2


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


def phase_junction_kernels(params, content, cache, cfg, name):
    """encoder_head, junction and decoder_tail against their plain
    versions, at the main path's shapes and at awkward ones."""
    flops, bw = peaks(name)
    hw = head_weights(params)
    img, ds, (f, wf, bf) = main_path_inputs(params, content, cache, cfg)
    gen = torch.Generator().manual_seed(SEED + 2)
    rand = lambda *shape: torch.rand(*shape, generator=gen).to(DEV)  # noqa: E731
    rows = []

    def run(kernel_name, case, kernel, plain, ops, nbytes, shape, main, library=None):
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()) and float(ref.abs().max()) > 0, f"{kernel_name} {case}: degenerate output")
        err = rel_max(got, ref)
        again = kernel()
        row = {"phase": "kernel", "kernel": kernel_name, "case": case, "shape": list(shape),
               "main_path": main, "rel_max_err": err, "max_abs_err": float((got - ref).abs().max()),
               "bitwise_repeatable": bool(torch.equal(got, again))}
        bound, by = conv_bound_ms(ops, nbytes, flops, bw)
        n = 10 if main else 3  # the main path's shapes are the ones PERF.md keeps
        row.update(ms=cuda_ms(kernel, n), plain_ms=cuda_ms(plain, n // 2 + 1), bound_ms=bound,
                   bound_by=by, library_ms=cuda_ms(library, 5) if library else None)
        emit(row)
        check(err <= JUNCTION_LIMIT, f"{kernel_name} vs plain at {case}: {err:.2e} > {JUNCTION_LIMIT}")
        check(row["bitwise_repeatable"], f"{kernel_name} at {case}: two calls differ")
        rows.append(row)

    def head_case(case, x, main=False):
        b, _, h, w = x.shape
        run("encoder_head", case, lambda: junction.encoder_head_cuda(x, *hw),
            lambda: junction._encoder_head_plain(x, *hw),
            b * 2 * h * w * 9 * (3 * 64 + 64 * 64), b * h * w * (3 + 16) * 4, x.shape, main)

    def junction_case(case, d, tw, deep, clip, main=False):
        b, _, h, w = d.shape
        args = (d, *tw, *hw, deep, clip)
        px = 4 * h * w
        ops = b * 2 * px * 9 * (64 * 64 + 64 * 3 + 3 * 64 + (64 * 64 if deep else 0))
        nbytes = b * 64 * 4 * (h * w + (h * w if deep else px))
        run("junction", case, lambda: junction.junction_cuda(*args),
            lambda: junction._junction_plain(*args), ops, nbytes, d.shape, main)

    def tail_case(case, x, w, b, clip, main=False):
        bsz, c, h, wd = x.shape
        library = None
        if main:  # the one PyTorch call that computes it: a grouped conv on the padded map
            xp = F.pad(x, (1, 1, 1, 1), mode="reflect").reshape(1, bsz * c, h + 2, wd + 2)
            wg, bg = w.reshape(bsz * 3, c, 3, 3).contiguous(), b.reshape(-1).contiguous()
            library = lambda: F.conv2d(xp, wg, bg, groups=bsz)  # noqa: E731
        run("decoder_tail", case, lambda: junction.decoder_tail_cuda(x, w, b, clip),
            lambda: junction._decoder_tail_plain(x, w, b, clip),
            bsz * 2 * h * wd * 9 * 64 * 3, bsz * h * wd * (64 + 3) * 4, x.shape, main, library)

    head_case("main_b4_512", img, main=True)
    for level, (d, tw) in ds.items():
        junction_case(level, d, tw, True, False, main=True)
    tail_case("main_b4_512", f, wf, bf, False, main=True)
    d3, tw = ds["relu3_1"]
    # The shallow variant at the main path's size, though the cascade never calls it.
    junction_case("relu3_1_shallow", d3, tw, False, False)
    for b, h, w in ((1, 16, 16), (2, 48, 32), (3, 64, 16), (1, 512, 512)):
        label = f"b{b}_{h}x{w}"
        head_case(label, rand(b, 3, h, w))
        for deep in (True, False):
            for clip in (False, True):  # ×20: the rgb stage leaves [0, 1], so the clip acts
                junction_case(f"{label}_{'deep' if deep else 'shallow'}{'_clip' if clip else ''}",
                              rand(b, 64, h // 2, w // 2) * 20, tw, deep, clip)
        for clip in (False, True):
            tail_case(f"{label}{'_clip' if clip else ''}", rand(b, 64, h, w),
                      (rand(b, 3, 64, 3, 3) - 0.5) * 0.2, rand(b, 3), clip)

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

    return {k: line(k) for k in ("encoder_head", "junction", "decoder_tail")}


def phase_main_fused(params, content, style, cfg, out_unfused, cache_unfused, cfg_unfused):
    """The fuse_junction cascade through the same entry points."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = cascade.precompute_style(params["encoder"], style, cfg)
    out = cascade.stylize_microbatched(params, content, cache, ALPHA, cfg, microbatch=MICROBATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    n_chunks = -(-N_CONTENT // MICROBATCH)
    expected = {"ns_sqrtm": 5 * (1 + n_chunks), "encoder_head": n_chunks,
                "junction": 3 * n_chunks, "decoder_tail": n_chunks}
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

    # One microbatch's stages as the fused cascade runs them.
    stages = {}
    enc = params["encoder"]
    head_args = tuple(enc[n][k] for n in ("conv0", "conv1_1", "conv1_2") for k in ("w", "b"))
    with torch.no_grad():
        x, kind = to_nchw(batch), "img"
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
                    m, bias = wct_ops.wct_transform_cn(feats.flatten(2), cache[level].stats,
                                                       ALPHA, method=cfg.method)
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


def phase_cli():
    work = ROOT / "build" / "chip_smoke"
    c_dir, o_dir = work / "content", work / "out"
    for d in (c_dir, o_dir):
        d.mkdir(parents=True, exist_ok=True)
        for f in d.iterdir():
            f.unlink()
    rng = np.random.default_rng(SEED + 1)
    for i in range(2):
        images.save_img(c_dir / f"c{i}.png", rng.random((300, 256, 3)))
    images.save_img(work / "style.png", rng.random((256, 320, 3)))
    cmd = [sys.executable, "-m", "wct_tpu_torch.cli.stylize",
           "--weights", "weights/bundle.npz", "--method", "newton_schulz_pallas",
           "--content-path", str(c_dir), "--style-path", str(work / "style.png"),
           "--out-path", str(o_dir), "--content-size", "256", "--batch-size", "2",
           "--alpha", str(ALPHA), "--device", DEV]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"CLI failed (rc {proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    outs = images.get_files(o_dir)
    check(len(outs) == 2, f"CLI wrote {len(outs)} outputs, expected 2")
    shapes = [images.get_img(p).shape for p in outs]
    check(all(s == (300, 256, 3) for s in shapes), f"CLI output shapes {shapes}")
    emit({"phase": "cli", "seconds": secs, "outputs": [str(Path(p).relative_to(ROOT)) for p in outs]})


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
    lines = {"ns_sqrtm": phase_kernel(params, content, cfg, name)}
    cache = cascade.precompute_style(params["encoder"], style, cfg)
    lines.update(phase_junction_kernels(params, content, cache, cfg, name))
    _, out_unfused = phase_main(params, content, style, cfg)
    counts = phase_main_fused(params, content, style, cfg_fused, out_unfused, cache, cfg)
    phase_cli()
    meta = {
        "ns_sqrtm": ("wct_tpu_torch/csrc/ns_sqrtm.cu", "wct_tpu/ops/sqrtm.py:169"),
        "encoder_head": ("wct_tpu_torch/csrc/encoder_head.cu", "wct_tpu/ops/junction_pallas.py:368"),
        "decoder_tail": ("wct_tpu_torch/csrc/decoder_tail.cu", "wct_tpu/ops/junction_pallas.py:467"),
        "junction": ("wct_tpu_torch/csrc/junction.cu", "wct_tpu/ops/junction_pallas.py:530"),
    }
    # ms, plain_ms and bound_ms are one microbatch's calls (5 ns_sqrtm, 1
    # head, 3 junctions, 1 tail); launches are the fused main path's run.
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
