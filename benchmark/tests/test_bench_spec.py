"""BENCHMARK.json and the files it names: every cell resolves its
configuration, traffic, limits and metric readers by name, and every
name, unit and key keeps to the benchmark's contract."""

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import reference, spec  # noqa: E402

BENCHMARK = spec.load_benchmark()
WORKLOADS = [w["name"] for w in BENCHMARK["workloads"]]
METRICS = BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["benchmark"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    for word in BENCHMARK["command"]:
        assert not word.startswith("/") and ".." not in word
    assert (BENCH.parent / BENCHMARK["command"][1]).is_file()


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entry_keys(section):
    for entry in BENCHMARK[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert ENTRY_KEYS[section] <= set(entry) <= ENTRY_KEYS[section] | extra, entry["name"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_resolves_its_files(workload):
    cell = spec.load_cell(workload)
    assert cell.chips in (1, 4)
    assert cell.traffic["driver"] == "offline"
    assert cell.limits
    if "reference" in cell.config:  # a variant, which may add numbers of its own
        variant = spec.reference_module(cell.config["reference"]).Reference
        assert issubclass(variant, reference.Reference)
    else:
        assert set(cell.limits) <= {"style_rel", "style_recolour_rel", "image_mean_abs",
                                    "image_mean_abs_median", "image_mean_abs_q80", "image_q99_abs"}
    assert int(cell.config.get("style_size", 512)) >= 16
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and len(cell.per_layer) >= 1
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_names_units_and_strings():
    names = [c["name"] for c in BENCHMARK["configs"]] + WORKLOADS + [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for name in names:
        assert spec.NAME.match(name), name
    for w in BENCHMARK["workloads"]:
        assert spec.NAME.match(w["config"]) and spec.NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for m in METRICS:
        assert spec.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCHMARK["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for c in BENCHMARK["configs"]:
        assert 1 <= len(c["source"]) <= 200
        assert c["file"].startswith("benchmark/") and (BENCH.parent / c["file"]).is_file()
        assert json.loads((BENCH.parent / c["file"]).read_text())["name"] == c["name"]
    assert len((BENCH.parent / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_file_under_paths_is_named_from_name_characters():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(BENCH.parent).as_posix()
        assert all(part and spec.NAME.match(part) for part in rel.split("/")), rel


def test_a_workload_not_in_the_benchmark_does_not_load():
    with pytest.raises(KeyError):
        spec.load_cell("wct5-bf16-fused.nothing")


def test_each_layer_is_one_name():
    layers = {m["layer"] for m in BENCHMARK["per_layer"]}
    assert layers == {"cascade", "convs", "transform", "kernels", "device"}


def test_each_end_to_end_metric_is_a_quantity_a_run_takes():
    """A metric ``<quantity>.<suffix>`` reports ``<quantity>``; each
    per-layer metric moves one that every cell it lists reports."""
    for m in BENCHMARK["end_to_end"]:
        assert m["name"].split(".")[0] in {"setup_s", "frames_per_s"}
    for m in BENCHMARK["per_layer"]:
        for w in m["workloads"]:
            assert m["moves"] in {e["name"] for e in spec.load_cell(w).end_to_end}


@pytest.mark.parametrize("name, file", [("cascade.mfu.f32", "cascade.mfu.py"),
                                        ("junction_roofline", "junction_roofline.py")])
def test_a_split_metric_is_read_by_its_quantitys_reader(name, file):
    assert Path(spec.metric_reader(name).__code__.co_filename).name == file
