"""Decoder training CLI, the port of ``wct_tpu/cli/train.py``.

    python -m wct_tpu_torch.cli.train --relu-target relu3_1 \
        --content-path /data/coco --checkpoint-dir ckpt/relu3_1 \
        --encoder-weights weights/bundle.npz --max-iter 80000
    python -m wct_tpu_torch.cli.train --synthetic --synthetic-pool 1024 \
        --encoder-weights weights/bundle.npz --relu-target relu5_1 \
        --checkpoint-dir ckpt/relu5_1

Trains ONE decoder per invocation (run once per relu target), on
``--device`` (default cuda). Batches come from a device-resident pool
(``--synthetic-pool``) or through the pinned-memory prefetcher;
``state_latest.npz`` is written every ``--save-iter`` steps and on
SIGTERM/SIGINT, in the JAX package's layout, so either package resumes
it; ``decoder_<target>.npz`` is the decoder in the layout both stylize
CLIs read. Metrics go to ``metrics.jsonl``; they stay on the device
between summary steps, so the loop never waits on the card otherwise.
``--data-parallel`` splits each batch over every card of ``--device``
(``trainer.make_sharded_train_step``) when there is more than one.
"""

from __future__ import annotations

import argparse
import functools
import json
import signal
import threading
import time
from pathlib import Path

import numpy as np
import torch

from wct_tpu_torch.models import decoder, vgg
from wct_tpu_torch.parallel import mesh as mesh_lib
from wct_tpu_torch.train import checkpoint
from wct_tpu_torch.train.data import (
    DevicePrefetcher,
    batch_generator,
    device_pool_batches,
    synthetic_batches,
    synthetic_pool,
)
from wct_tpu_torch.train.trainer import (
    TrainConfig,
    eval_step,
    init_train_state,
    make_sharded_train_step,
    restore_train_state,
    state_tree,
    train_state_from_params,
    train_step,
)
from wct_tpu_torch.utils import images
from wct_tpu_torch.utils.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--relu-target", default="relu4_1")
    p.add_argument("--content-path", default=None, help="training image dir")
    p.add_argument("--val-path", default=None, help="validation image dir")
    p.add_argument("--synthetic", action="store_true",
                   help="procedural training images (no dataset needed)")
    p.add_argument("--synthetic-pool", type=int, default=0,
                   help="pre-generate this many procedural images, upload them "
                        "once and sample + augment on the device "
                        "(0 = generate fresh on the host)")
    p.add_argument("--encoder-weights", default=None,
                   help="npz with encoder params (or bundle with 'encoder'); "
                        "omit for random encoder (smoke test)")
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--init-decoder", default=None,
                   help="npz with decoder init params (a single decoder "
                        "tree, or {relu_target: tree}); applies at step 0 "
                        "only — --resume takes precedence")
    p.add_argument("--ckpt-format", choices=["npz", "orbax"], default="npz",
                   help="training-state backend: npz = single "
                        "state_latest.npz; orbax = step-indexed directories "
                        "<checkpoint-dir>/orbax/<step>/ (the port's own "
                        "on-disk form), restored from the highest step")
    p.add_argument("--ckpt-keep", type=int, default=3,
                   help="orbax: number of recent step checkpoints kept")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--crop-size", type=int, default=256)
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--lr-decay", type=float, default=5e-5)
    p.add_argument("--max-iter", type=int, default=160_000)
    p.add_argument("--save-iter", type=int, default=5_000)
    p.add_argument("--summary-iter", type=int, default=100)
    p.add_argument("--pixel-weight", type=float, default=1.0)
    p.add_argument("--feature-weight", type=float, default=1.0)
    p.add_argument(
        "--grad-clip", type=float, default=0.0,
        help="global-norm gradient clip (0 = off); stateless, so "
        "--resume across a clip change keeps the Adam moments",
    )
    p.add_argument(
        "--feature-norm", action="store_true",
        help="normalize the feature L2 by the target features' mean "
        "square (scale-free; ~no-op for the reference's normalised VGG, "
        "essential for unnormalised encoders)",
    )
    p.add_argument("--tv-weight", type=float, default=0.0)
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--tensorboard", action="store_true",
                   help="also write TensorBoard event files (needs the "
                        "tensorboard package; JSONL metrics always written)")
    p.add_argument("--remat", action="store_true",
                   help="recompute forward activations in the backward "
                        "pass (fits larger crops/batches in device memory)")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard the batch over all local devices "
                        "(trainer.make_sharded_train_step; one device trains "
                        "as without it)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; 'cpu' for tests)")
    return p.parse_args(argv)


def _load_encoder(args, dev: torch.device) -> dict:
    if args.encoder_weights:
        tree = checkpoint.load_pytree(args.encoder_weights)
        tree = tree["encoder"] if "encoder" in tree else tree
        return checkpoint.params_from_numpy(tree, dev)
    print("[train] NOTE: random encoder weights (smoke test)")
    return vgg.init_encoder_params(torch.Generator().manual_seed(args.seed), dev)


def _config(args) -> TrainConfig:
    return TrainConfig(
        relu_target=args.relu_target,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        lr_decay=args.lr_decay,
        pixel_weight=args.pixel_weight,
        feature_weight=args.feature_weight,
        feature_norm=args.feature_norm,
        grad_clip=args.grad_clip,
        tv_weight=args.tv_weight,
        crop_size=args.crop_size,
        max_iter=args.max_iter,
        save_iter=args.save_iter,
        summary_iter=args.summary_iter,
        compute_dtype=args.dtype,
        remat=args.remat,
    )


def _batches(args, cfg: TrainConfig, dev: torch.device, start_step: int, pool: int):
    """Training batches on ``dev``: from a device-resident pool of ``pool``
    synthetic images, or through the prefetcher (synthetic images, from
    ``--synthetic-pool`` images on the host when ``pool`` is 0, or files)."""
    if args.synthetic or not args.content_path:
        if not args.synthetic:
            print("[train] NOTE: no --content-path; using synthetic images")
        if pool > 0:
            pool_np = synthetic_pool(np.random.default_rng(args.seed), pool, cfg.crop_size)
            print(f"[train] device-resident pool: {pool} images "
                  f"({pool_np.nbytes / 1e6:.0f} MB uploaded once), on-device "
                  "sampling + augmentation")
            return device_pool_batches(
                pool_np, cfg.batch_size, args.seed, start_step=start_step, device=dev
            )
        batches = synthetic_batches(cfg.batch_size, cfg.crop_size, args.seed,
                                    pool_size=args.synthetic_pool)
    else:
        paths = images.get_files(args.content_path)
        print(f"[train] {len(paths)} training images")
        batches = batch_generator(paths, cfg.batch_size, cfg.crop_size, args.seed)
    return DevicePrefetcher(batches, depth=4, device=dev)


def _val_batch(args, cfg: TrainConfig, dev: torch.device):
    """Fixed validation batch: center crops from --val-path."""
    if not args.val_path:
        return None
    val_paths = images.list_images(args.val_path)[: cfg.batch_size]
    if not val_paths:
        print(f"[train] WARNING: no images under --val-path {args.val_path}; "
              "validation disabled")
        return None
    print(f"[train] validating on {len(val_paths)} images")
    crops = np.stack([images.center_crop(images.get_img(p), cfg.crop_size) for p in val_paths])
    return torch.from_numpy(crops).to(dev)


def main(argv=None) -> None:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = _config(args)
    ckpt_dir = Path(args.checkpoint_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    enc_params = _load_encoder(args, dev)

    state = init_train_state(torch.Generator().manual_seed(args.seed + 1), cfg, dev)
    if args.init_decoder:
        # Closed-form layerwise init (train/layerwise.py): fresh Adam
        # moments over the solved params. A --resume restore overrides it.
        tree = checkpoint.load_pytree(args.init_decoder)
        if args.relu_target in tree:
            tree = tree[args.relu_target]
        state = train_state_from_params(checkpoint.params_from_numpy(tree, dev), cfg)
        print(f"[train] initialized decoder from {args.init_decoder}")
    ckptr = checkpoint.TrainCheckpointer(ckpt_dir, fmt=args.ckpt_format, keep=args.ckpt_keep)
    if args.resume:
        tree = ckptr.restore_latest()
        if tree is not None:
            state = restore_train_state(tree, cfg, dev)
            print(f"[train] resumed ({args.ckpt_format}) at step {state.step}")

    step_fn = functools.partial(train_step, cfg=cfg)
    pool = args.synthetic_pool
    mesh = mesh_lib.create_mesh(device=args.device) if args.data_parallel else None
    if mesh is not None and len(mesh.devices) > 1:
        step_fn = make_sharded_train_step(mesh, cfg)
        print(f"[train] data-parallel over {len(mesh.devices)} devices")
        if pool > 0 and (args.synthetic or not args.content_path):
            # As the reference: the pool would need sharding per device.
            print("[train] NOTE: --synthetic-pool device residency is disabled "
                  "under --data-parallel (the pool would need per-device "
                  "sharding); falling back to host prefetch")
            pool = 0
    batches = _batches(args, cfg, dev, state.step, pool)
    val_batch = _val_batch(args, cfg, dev)

    # Save on a signal: SIGTERM/SIGINT sets a flag; the loop checkpoints
    # and exits cleanly, so a preempted run resumes from its exact step.
    # The old handlers come back on exit; off the main thread none is set.
    stop_requested = False

    def _request_stop(signum, frame):  # noqa: ARG001
        nonlocal stop_requested
        stop_requested = True
        print(f"[train] signal {signum}: checkpointing and stopping", flush=True)

    prev_handlers = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[sig] = signal.signal(sig, _request_stop)

    tb_writer = None
    if args.tensorboard:
        from wct_tpu_torch.utils.tb import SummaryWriter

        tb_writer = SummaryWriter(ckpt_dir / "tb")
        if not tb_writer.active:
            print("[train] tensorboard requested but unavailable; skipping")

    t0 = time.time()
    try:
        with (ckpt_dir / "metrics.jsonl").open("a") as log_file:
            for batch in batches:
                state, metrics = step_fn(state, enc_params, batch)
                step = state.step
                if step % cfg.summary_iter == 0:
                    # The one host read of the window: every metric at once.
                    vals = torch.stack([v.float() for v in metrics.values()]).tolist()
                    m = dict(zip(metrics, vals))
                    m["step"] = step
                    # Throughput measured BEFORE the val pass.
                    m["img_per_sec"] = (
                        cfg.batch_size * cfg.summary_iter / max(time.time() - t0, 1e-9)
                    )
                    if val_batch is not None:
                        val = eval_step(state.params, enc_params, val_batch, cfg)
                        m.update({f"val_{k}": float(v) for k, v in val.items()})
                    t0 = time.time()
                    log_file.write(json.dumps(m) + "\n")
                    log_file.flush()
                    if tb_writer is not None and tb_writer.active:
                        tb_writer.scalars(step, {k: v for k, v in m.items() if k != "step"})
                    print(f"step {step}: loss {m['loss']:.4f} "
                          f"(pixel {m['pixel']:.4f}, feature {m['feature']:.4f}) "
                          f"{m['img_per_sec']:.1f} img/s", flush=True)
                if step % cfg.save_iter == 0 or step >= cfg.max_iter or stop_requested:
                    if val_batch is not None:
                        # Reconstructions as PNGs beside the checkpoint.
                        with torch.no_grad():
                            code = vgg.encode(enc_params, val_batch, cfg.relu_target)
                            decoded = decoder.decode(state.params, code, cfg.relu_target)
                        for i, img in enumerate(decoded[:4].float().cpu().numpy()):
                            images.save_img(ckpt_dir / f"val_recon_{i}_step{step}.png", img)
                    ckptr.save(step, state_tree(state))
                    checkpoint.save_pytree(
                        ckpt_dir / f"decoder_{cfg.relu_target}.npz",
                        checkpoint.params_to_numpy(state.params),
                    )
                if step >= cfg.max_iter or stop_requested:
                    break
    finally:
        ckptr.close()
        if tb_writer is not None:
            tb_writer.close()
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
    print(f"[train] done at step {state.step}; decoder saved to {ckpt_dir}")


if __name__ == "__main__":
    main()
