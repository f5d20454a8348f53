"""A whole run of a cell on the CPU at a small size: the result line's
keys, a sound run judged correct, and each fault a cell can have judged
not correct. On the card, the control at the cell's own size comes out
not correct (marked ``cuda``)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import run  # noqa: E402
from harness import check, program, reference, spec  # noqa: E402
from wct_tpu_torch.models import cascade  # noqa: E402

SEED = 2**31 + 4242  # beyond 32 signed bits, as the driver's are


WORKLOADS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def small(workload, **overrides):
    """The cell at 32 × 48 on the CPU, a pool of 6 in jobs of 4 at
    microbatch 2, every output checked."""
    cell = spec.load_cell(workload)
    cell.traffic = dict(cell.traffic, height=32, width=48, pool_images=6, check_images=64,
                        warmup_jobs=1, job_images=4, microbatch=2, **overrides)
    return cell


def committed_counts(workload, monkeypatch):
    """The cell at 32 × 48 on the CPU with its traffic's own pool, job,
    microbatch and check sizes, so each pool image lands in the same
    microbatch slot as in a run on the card; the window sends the pool
    once, whatever the CPU's speed."""
    from harness import drivers

    cell = spec.load_cell(workload)
    cell.traffic = dict(cell.traffic, height=32, width=48, warmup_jobs=1)
    jobs = cell.traffic["pool_images"] // cell.traffic["job_images"]
    monkeypatch.setattr(drivers.Offline, "window", lambda self, seconds: self._loop(
        jobs=jobs, sample=drivers._Reservoir(self.check_images, self.seed)))
    return cell


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def measure(cell, seconds=0.4):
    return run.measure(cell, SEED, seconds, False, device="cpu")


def test_result_line_has_the_contract_keys():
    cell = small("wct5-bf16-fused.offline512")
    r = measure(cell)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end} == {"frames_per_s.bf16", "setup_s"}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    assert set(r["checks"]) == set(cell.limits) | {"failed"}
    assert r["attempted"] >= 4 and r["failed"] == 0
    json.dumps(r)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_sound_run_is_correct(workload):
    r = measure(small(workload))
    assert r["correct"], r["checks"]


def _identity(params, content, cache, alpha, cfg):
    return torch.as_tensor(content, dtype=torch.float32).clone()


def _alpha_altered(params, content, cache, alpha, cfg, _orig=cascade.stylize):
    return _orig(params, content, cache, float(alpha) - 0.1, cfg)


def _half_batch(params, content, cache, alpha, cfg, _orig=cascade.stylize):
    half = max(1, content.shape[0] // 2)
    out = _orig(params, content[:half], cache, alpha, cfg)
    return torch.cat([out, out[:1].expand(content.shape[0] - half, -1, -1, -1)])


def _one_slot_altered(params, content, cache, alpha, cfg, _orig=cascade.stylize):
    """The last image of each microbatch stylized at α − 0.1, the others sound."""
    out = _orig(params, content, cache, alpha, cfg)
    last = _orig(params, content[-1:], cache, float(alpha) - 0.1, cfg)
    return torch.cat([out[:-1], last])


FAULTS = {"state_unchanged": _identity, "answer_altered": _alpha_altered,
          "half_batch_left_out": _half_batch, "one_slot_altered": _one_slot_altered}


def broken_in_the_window(monkeypatch, fault):
    """Set-up (the style's statistics) stays sound: the fault is in the window."""
    from harness import drivers

    real_window = drivers.Offline.window

    def broken_window(self, seconds):
        with monkeypatch.context() as m:
            m.setattr(cascade, "stylize", FAULTS[fault])
            return real_window(self, seconds)

    monkeypatch.setattr(drivers.Offline, "window", broken_window)


@pytest.mark.parametrize("workload, fault", [(w, f) for w in WORKLOADS for f in sorted(FAULTS)])
def test_a_fault_in_the_timed_path_is_not_correct(monkeypatch, fault, workload):
    broken_in_the_window(monkeypatch, fault)
    r = measure(small(workload))
    assert not r["correct"], r["checks"]


# The cells whose limits judge a statistic over the images other than the
# largest (which any spoilt image moves, wherever it sits).
OVER_IMAGES = [w for w in WORKLOADS if set(spec.load_cell(w).limits) - {"image_mean_abs", "image_q99_abs"}]


@pytest.mark.parametrize("workload", OVER_IMAGES)
def test_a_sound_run_is_correct_at_the_committed_counts(monkeypatch, workload):
    cell = committed_counts(workload, monkeypatch)
    r = measure(cell)
    assert r["attempted"] == cell.traffic["pool_images"] == cell.traffic["check_images"]
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("workload, fault", [(w, f) for w in OVER_IMAGES
                                             for f in ("half_batch_left_out", "one_slot_altered")])
def test_a_fault_in_one_slot_is_not_correct_at_the_committed_counts(monkeypatch, fault, workload):
    """A fault that spoils a fixed share of each microbatch, with the
    committed traffic's pool, job, microbatch and check sizes."""
    cell = committed_counts(workload, monkeypatch)
    broken_in_the_window(monkeypatch, fault)
    r = measure(cell)
    assert r["attempted"] == cell.traffic["pool_images"]
    assert not r["correct"], r["checks"]


def test_outputs_handed_back_for_other_images_are_not_correct(monkeypatch):
    """Each job's outputs handed back one place along, every image sound."""
    real = program.stylize_job
    monkeypatch.setattr(program, "stylize_job",
                        lambda *a, **k: torch.roll(real(*a, **k), 1, dims=0))
    r = measure(small("wct5-bf16-fused.offline512"))
    assert not r["correct"], r["checks"]


def test_reference_agrees_with_the_port_on_the_cpu():
    """The default route in f32 on the CPU against the float64 reference:
    each level's transform, encoder and decoder compose the same image."""
    cell = small("wct5-f32-fidelity.offline512")
    cfg = program.cascade_config(cell.config)
    params = program.load_params(cell.config, "cpu")
    rng = np.random.default_rng(3)
    style = (rng.random((48, 48, 3)) * 255).astype(np.uint8)
    content = (rng.random((2, 32, 48, 3)) * 255).astype(np.uint8)
    stats = program.style_statistics(program.precompute_style(params, style, cfg))
    out = program.stylize_job(params, torch.as_tensor(content).float() / 255.0,
                              program.precompute_style(params, style, cfg), 0.6, cfg, 2)
    samples = [(i, check.quantise(out[i]).numpy()) for i in range(2)]
    r = check.readings(cell.config, style, stats, samples, content, "cpu")
    assert r["style_rel"] < 1e-3 and r["image_mean_abs"] < 0.1, r


def test_reference_precisions_round_as_stated():
    ref = reference.Reference(reference.load_bundle(spec.ROOT / "weights/bundle.npz"), "cpu", "tf32")
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 2.0**-9, 3.0])
    assert ref.q(x).tolist() == [1.0 + 2.0**-10, 1.0 + 2.0**-9, 3.0]
    ref.precision = "fp8"
    y = ref.q(torch.tensor([448.0, 1.0]))
    assert y[0] == 448.0 and y[1] == pytest.approx(1.0, rel=0.07)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["wct5-bf16-fused.offline512", "wct5-f32-fidelity.offline512"])
def test_the_control_is_not_correct_on_the_card(workload):
    """The reference one precision step below the configuration's, in the
    program's place at the cell's own size, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = spec.load_cell(workload)
    params = reference.load_bundle(spec.ROOT / cell.config["weights"])
    for seed in (SEED, SEED + 1, SEED + 2):
        values = check.control_readings(cell.config, cell.traffic, seed, "cuda",
                                        reference_params=params)
        correct, checks = check.judge(values, cell.limits, 0, 1)
        assert not correct, checks
