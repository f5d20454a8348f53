"""A configuration that brings its own reference, style size and counters
as new files: the variant is loaded by name and judges the run, the style
size reaches both the driver and the control, a cache without colouring
matrices gives readings, declared counters are read, and without a
variant the readings are the plain WCT's own. Variants are written under
``tmp_path``."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import run  # noqa: E402
from harness import check, drivers, program, reference, spec  # noqa: E402
from wct_tpu_torch.ops import eigh  # noqa: E402

SEED = 2**31 + 5151
WORKLOADS = ["wct5-bf16-fused.offline512", "wct5-f32-fidelity.offline512"]

# AdaIN at every level (population variances, σ = √(var + 1e-5)), as a
# variant of the plain reference: its own style state, statistics under
# the program's names, a number of its own, and its transform.
ADAIN = '''
from harness import reference

EPS = 1e-5


def moments(x):
    return x.mean(dim=1), (x.var(dim=1, unbiased=False) + EPS).sqrt()


class Reference(reference.Reference):
    def style_state(self, level, f):
        return moments(f)

    def statistics(self, level, state):
        return {"adain.mean": state[0], "adain.std": state[1]}

    def extra_readings(self, got, want):
        gaps = [float((got[lv][k] - w).norm() / w.norm())
                for lv, stats in want.items() for k, w in stats.items() if k in got.get(lv, {})]
        return {"adain_rel": max(gaps)} if gaps else {}

    def transform(self, level, f, state, alpha):
        c, h, w = f.shape
        x = f.flatten(1)
        mu_c, std_c = moments(x)
        mu_s, std_s = state
        out = std_s[:, None] * (x - mu_c[:, None]) / std_c[:, None] + mu_s[:, None]
        return self.q(alpha * out + (1.0 - alpha) * x).reshape(c, h, w)
'''


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def variants(tmp_path, monkeypatch):
    """``references/`` under ``tmp_path``, holding ``adain_test.py``."""
    (tmp_path / "adain_test.py").write_text(ADAIN)
    monkeypatch.setattr(spec, "REFERENCES", tmp_path)
    return tmp_path


def small(workload="wct5-f32-fidelity.offline512", limits=None, **config):
    """The cell at 32 × 48 on the CPU, a pool of 6 in jobs of 4 at
    microbatch 2, every output checked, its configuration changed by
    ``config`` and its limits replaced by ``limits``."""
    cell = spec.load_cell(workload)
    cell.config = dict(cell.config, **config)
    cell.traffic = dict(cell.traffic, height=32, width=48, pool_images=6, check_images=64,
                        warmup_jobs=1, job_images=4, microbatch=2)
    if limits is not None:
        cell.limits = limits
    return cell


def measure(cell):
    return run.measure(cell, SEED, 0.4, False, device="cpu")


ADAIN_LIMITS = {"image_mean_abs": 1.0, "adain_rel": 1e-4}


def test_the_configuration_names_its_reference(variants):
    config = small(reference="adain_test").config
    ref = check.reference_for(config, "cpu")
    assert isinstance(ref, reference.Reference) and type(ref) is not reference.Reference
    assert type(check.reference_for(small().config, "cpu")) is reference.Reference
    with pytest.raises(FileNotFoundError):
        check.reference_for(dict(config, reference="no_such_variant"), "cpu")


def test_a_variant_that_is_no_subclass_is_refused(variants):
    (variants / "plain.py").write_text("class Reference:\n    pass\n")
    with pytest.raises(TypeError):
        check.reference_for(small(reference="plain").config, "cpu")


def test_a_run_is_judged_against_the_variants_transform(variants):
    """The program's AdaIN cascade against the AdaIN variant: correct,
    with the variant's own number read from the program's AdaIN cache."""
    r = measure(small(reference="adain_test", cascade={"transform": "adain"}, limits=ADAIN_LIMITS))
    assert r["correct"], r["checks"]
    assert r["checks"]["adain_rel"]["value"] < 1e-5


def test_a_run_that_follows_the_plain_wct_is_not_correct_against_the_variant(variants):
    r = measure(small(reference="adain_test", limits=ADAIN_LIMITS))
    assert not r["correct"], r["checks"]
    assert r["checks"]["image_mean_abs"]["value"] > 1.0
    assert r["checks"]["adain_rel"]["value"] is None  # a WCT cache holds no AdaIN moments


def test_an_adain_cache_gives_readings_and_a_missing_number_is_not_correct(variants):
    """No level of an AdaIN cache holds a colouring matrix: the readings
    have no style numbers, and a limits file that names one is not correct."""
    config = small(reference="adain_test", cascade={"transform": "adain"}).config
    stats = program.style_statistics(program.precompute_style(
        program.load_params(config, "cpu"), np.full((32, 32, 3), 128, np.uint8),
        program.cascade_config(config)))
    assert set(stats["relu5_1"]) == {"adain.mean", "adain.std"}
    r = measure(small(reference="adain_test", cascade={"transform": "adain"},
                      limits=dict(ADAIN_LIMITS, style_rel=1.0)))
    assert not r["correct"]
    assert r["checks"]["style_rel"] == {"value": None, "limit": 1.0}
    assert r["checks"]["adain_rel"]["value"] < 1e-5


def test_the_style_size_reaches_the_driver_and_the_control(monkeypatch):
    cell = small(style_size=64)
    d = drivers.make(cell.config, cell.traffic, SEED, "cpu")
    assert d.style.shape == (64, 64, 3)
    assert "style_size" not in small().config
    assert drivers.style_image(small().config, SEED, "cpu").shape == (512, 512, 3)

    seen = []
    real = reference.Reference.style_stats
    monkeypatch.setattr(reference.Reference, "style_stats",
                        lambda self, style: seen.append(np.asarray(style)) or real(self, style))
    traffic = dict(cell.traffic, check_images=1)
    check.control_readings(cell.config, traffic, SEED, "cpu", "float32")
    assert len(seen) == 2 and all(np.array_equal(s, d.style) for s in seen)


def test_a_counter_declared_by_a_metric_module_is_read(tmp_path):
    metrics = tmp_path / "benchmark" / "metrics"
    metrics.mkdir(parents=True)
    (metrics / "x.eigh_calls.py").write_text(
        'COUNTERS = {"eigh": "ops.eigh.eigh_cuda.launches",\n'
        '            "junction_f32_again": "ops.junction.junction_cuda.launches_by_dtype.f32",\n'
        '            "renamed": "ops.eigh.eigh_cuda.calls", "gone": "ops.no_such_module.n"}\n'
        "def read(ctx):\n    return None\n")
    (metrics / "y.py").write_text("def read(ctx):\n    return None\n")
    declared = spec.declared_counters([{"name": "x.eigh_calls"}, {"name": "y"}], tmp_path)
    assert set(declared) == {"eigh", "junction_f32_again", "renamed", "gone"}
    counts = program.counters(declared)
    assert counts["eigh"] == eigh.eigh_cuda.launches
    assert counts["junction_f32_again"] == counts["junction_f32"]
    assert counts["renamed"] is None and counts["gone"] is None
    assert {"junction_f32", "junction_bf16", "centered_gram"} <= set(counts)

    (metrics / "z.py").write_text('COUNTERS = {"eigh": "ops.gram.centered_gram_cuda.launches"}\n'
                                  "def read(ctx):\n    return None\n")
    with pytest.raises(ValueError):
        spec.declared_counters([{"name": "x.eigh_calls"}, {"name": "z"}], tmp_path)


def test_the_committed_cells_declare_counters_that_resolve():
    for workload in WORKLOADS:
        for key, path in spec.declared_counters(spec.load_cell(workload).per_layer).items():
            assert isinstance(program.counter(path), int), (workload, key, path)


def _plain_wct_readings(config, style, program_stats, samples, pool):
    """The numbers by the plain reference's own steps: each level's
    encoder, covariance, powers, ``Reference.wct`` and decoder, written out."""
    ref = reference.Reference(reference.load_bundle(spec.ROOT / config["weights"]), "cpu",
                              "float64", method=config["reference_method"],
                              levels=config["relu_targets"])
    img = ref._nchw(style)
    stats = {}
    for level in ref.levels:
        cov, mean = ref.covariance(ref.encode(img, level)[0].flatten(1))
        stats[level] = (ref.powers(cov)[0], mean)
    got = {lv: (s["stats.kernel"], s["stats.mean"]) for lv, s in program_stats.items()}
    means, q99s = [], []
    for index, out in samples:
        x = ref._nchw(pool[index])
        for level in ref.levels:
            f = ref.wct(ref.encode(x, level)[0], stats[level], float(config["alpha"]))[None]
            x = ref.decode(f, level)
        m, q = check.image_gap(out, x[0].clamp(0.0, 1.0).permute(1, 2, 0))
        means.append(m)
        q99s.append(q)
    return {"style_rel": check.style_gap(got, stats),
            "style_recolour_rel": check.recolour_gap(got, ref.style_features(style)),
            "image_mean_abs": max(means), "image_mean_abs_each": means, "image_q99_abs": max(q99s)}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_without_a_variant_the_readings_are_the_plain_wcts_own(workload):
    cell = small(workload)
    config = cell.config
    assert "reference" not in config and "style_size" not in config
    params = program.load_params(config, "cpu")
    cfg = program.cascade_config(config)
    rng = np.random.default_rng(11)
    style = (rng.random((48, 48, 3)) * 255).astype(np.uint8)
    pool = (rng.random((2, 32, 48, 3)) * 255).astype(np.uint8)
    cache = program.precompute_style(params, style, cfg)
    out = program.stylize_job(params, torch.as_tensor(pool).float() / 255.0, cache,
                              float(config["alpha"]), cfg, 2)
    samples = [(i, check.quantise(out[i].float()).numpy()) for i in range(2)]
    stats = program.style_statistics(cache)
    got = check.readings(config, style, stats, samples, pool, "cpu")
    want = _plain_wct_readings(config, style, stats, samples, pool)
    assert {k: got[k] for k in want} == want
    assert got["image_mean_abs_q80"] == float(np.quantile(want["image_mean_abs_each"], 0.8))
