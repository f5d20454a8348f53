#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100. It
builds every CUDA kernel of the port from ``wct_tpu_torch/csrc``, holds
each against its plain PyTorch version at the main path's shapes, runs
the five-level relu5_1 → relu1_1 cascade with
``CascadeConfig(method="newton_schulz_pallas")`` at 512 px on the
trained ``weights/bundle.npz`` through ``precompute_style`` and
``stylize_microbatched``, checks the outputs, and runs the CLI once.

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

from wct_tpu_torch.models import cascade, decoder, vgg
from wct_tpu_torch.ops import _build, sqrtm
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
    sqrtm.ns_sqrtm_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = cascade.precompute_style(params["encoder"], style, cfg)
    out = cascade.stylize_microbatched(params, content, cache, ALPHA, cfg, microbatch=MICROBATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sqrtm.ns_sqrtm_cuda.launches
    n_levels = len(cfg.relu_targets)
    n_chunks = -(-N_CONTENT // MICROBATCH)
    check(launches == n_levels * (1 + n_chunks),
          f"ns_sqrtm launched {launches} times, expected {n_levels * (1 + n_chunks)}")
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
    runs = 5
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
    return launches


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
    ns = phase_kernel(params, content, cfg, name)
    launches = phase_main(params, content, style, cfg)
    phase_cli()
    print(json.dumps({"kernels": [{
        "name": "ns_sqrtm", "route": "cuda", "source": "wct_tpu_torch/csrc/ns_sqrtm.cu",
        "replaces": "wct_tpu/ops/sqrtm.py:169", "launches": launches,
        "max_abs_err": ns["max_abs_err"], "ms": ns["ms"], "plain_ms": ns["plain_ms"],
        "bound_ms": ns["bound_ms"], "bound_by": ns["bound_by"], "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
