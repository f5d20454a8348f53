"""Per-call times of ``stylize_spatial`` with and without pack2 on the card,
with the caching allocator's counters around every call.

    python -m wct_tpu_torch.tools.spatial_pack2_turns

Run from the repo root on a machine with a card. Builds the kernels and
runs ``chip_smoke.py``'s ``mesh_spatial_pack2`` rows (two 2048² images on
four shards of ``cuda:0``, the f32 Newton–Schulz-kernel route in each
pack2 scope and bf16 throughput) twice: on a fresh process, then after
``chip_smoke.py``'s ``mesh_dp`` and ``mesh_spatial`` phases have run, as
in the smoke run. Every call of the rows' turns (off, on, on, off) is
timed alone and printed as a JSON line with the allocator's retries
(a retry frees every cached block and allocates again), its device
allocations and frees, the bytes reserved after it, and the card's SM
clock, power and temperature; the phases print their own lines, the
second pass's rows in ``mesh_spatial``'s, and the last line holds the
first pass's.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from wct_tpu_torch.utils.device import cuda_ms

ROOT = Path(__file__).resolve().parents[2]


def _allocator() -> dict:
    stats = torch.cuda.memory_stats()
    return {k: stats.get(k, 0) for k in ("num_alloc_retries", "num_device_alloc", "num_device_free")}


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from wct_tpu_torch.parallel import mesh as mesh_lib
    from wct_tpu_torch.train import checkpoint

    label = {"pass": "fresh"}

    def in_turns(a, b, runs=2):
        times = {"off": [], "on": []}
        for tag, fn in (("off", a), ("on", b), ("on", b), ("off", a)):
            before, t0 = _allocator(), time.perf_counter()
            ms = cuda_ms(fn, iters=runs, warmup=0)
            after = _allocator()
            times[tag].append(ms)
            print(json.dumps({**label, "turn": tag, "ms": ms, "host_s": time.perf_counter() - t0,
                              **{k: after[k] - before[k] for k in after},
                              "reserved_bytes": torch.cuda.memory_reserved(), "card": _card()}),
                  flush=True)
        return float(np.mean(times["off"])), float(np.mean(times["on"]))

    cs.in_turns = in_turns
    cs.phase_device()
    cs.phase_build()
    params = checkpoint.params_from_numpy(checkpoint.load_pytree(ROOT / "weights" / "bundle.npz"), cs.DEV)
    rng = np.random.default_rng(cs.SEED)
    rng.random((cs.N_CONTENT, cs.SIZE, cs.SIZE, 3))  # chip_smoke's content, drawn first
    style = rng.random((cs.SIZE, cs.SIZE, 3)).astype(np.float32)
    img = torch.as_tensor(np.random.default_rng(cs.SEED + 31).random(
        (1, cs.MESH_SPATIAL_SIZE, cs.MESH_SPATIAL_SIZE, 3), dtype=np.float32), device=cs.DEV)
    mesh = mesh_lib.create_mesh(cs.MESH_SHARDS, "sp", device="cuda:0")
    rows = {"fresh": cs.mesh_spatial_pack2(params, style, img, mesh)}
    label["pass"] = "after_mesh_phases"
    cs.phase_mesh_dp(params, style)
    cs.phase_mesh_spatial(params, style)  # its last rows are mesh_spatial_pack2's
    print(json.dumps({"card": cs.card_name(), "fresh": rows["fresh"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
