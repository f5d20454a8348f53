"""The benchmark's definition and the files it names.

``BENCHMARK.json`` at the root of the checkout lists configurations,
workloads (cells) and metrics. Everything that belongs to one of them
sits in a file of its own, found by its name:

- a configuration: ``benchmark/configs/<config>.json`` (the entry's
  ``file``);
- a traffic mix: ``benchmark/traffic/<traffic>.json``, the parameters
  the one load generator (``harness/drivers.py``) reads;
- a cell's limits of ``correct``: ``benchmark/limits/<workload>.json``;
- a per-layer metric: ``benchmark/metrics/<metric>.py``, a reader
  ``read(ctx) -> float | None``; ``<quantity>.<suffix>`` falls back to
  ``<quantity>.py``. A reader may declare the program's counters it reads,
  ``COUNTERS = {key: path under wct_tpu_torch}``;
- a configuration's own reference, where its file names one
  (``"reference": "<name>"``): ``benchmark/references/<name>.py``, a
  subclass ``Reference`` of ``harness/reference.py``'s.

An end-to-end metric ``<quantity>.<suffix>`` reports ``<quantity>``
(``frames_per_s.f32`` is ``frames_per_s`` in the cells it lists), so one
quantity can take a bound per kind of cell.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
REFERENCES = BENCH_DIR / "references"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    limits: dict  # {number: limit}
    end_to_end: list[dict]  # the metrics this cell reports with --trace 0
    per_layer: list[dict]  # and with --trace 1
    chips: int


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def reports(metric: dict, workload: str) -> bool:
    """Whether a metric is reported in ``workload``: listed there, or
    in every cell when it lists none."""
    return workload in metric.get("workloads", [workload])


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell called ``workload`` with every file it names; raises if
    it is not in ``BENCHMARK.json`` or a file is missing."""
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    return cell_from(entry, bench)


def cell_from(entry: dict, bench: dict) -> Cell:
    """The cell of a ``workloads`` entry (``name``, ``config``, ``traffic``,
    ``chips``) with its files and the metrics ``bench`` has it report."""
    name = entry["name"]
    config_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _json(ROOT / config_entry["file"])
    traffic = _json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    limits = _json(BENCH_DIR / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    layer = [m for m in bench["per_layer"] if reports(m, name)]
    return Cell(name, config, traffic, limits, e2e, layer, int(entry["chips"]))


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None or not path.is_file():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_module(name: str, root: Path = ROOT):
    """The module ``benchmark/metrics/<name>.py``; a metric
    ``<quantity>.<suffix>`` with no file of its own (one quantity split
    by the end-to-end metric it moves) is ``<quantity>.py``."""
    stem = name
    while not (root / "benchmark" / "metrics" / f"{stem}.py").exists() and "." in stem:
        stem = stem.rpartition(".")[0]
    path = root / "benchmark" / "metrics" / f"{stem}.py"
    return _module(path, f"bench_metric_{name.replace('.', '_')}")


def metric_reader(name: str, root: Path = ROOT):
    """The ``read`` function of the metric's module (``metric_module``)."""
    return metric_module(name, root).read


def declared_counters(metrics: list[dict], root: Path = ROOT) -> dict:
    """``{key: path}`` of every program counter that the readers of
    ``metrics`` declare (their modules' ``COUNTERS``); raises where two
    declare one key with different paths."""
    out: dict = {}
    for m in metrics:
        for key, path in getattr(metric_module(m["name"], root), "COUNTERS", {}).items():
            if out.setdefault(key, path) != path:
                raise ValueError(f"counter {key!r} declared as {out[key]!r} and {path!r}")
    return out


def reference_module(name: str):
    """The module ``references/<name>.py`` of a configuration that names
    its own reference."""
    if not NAME.match(name):
        raise ValueError(f"not a reference name: {name!r}")
    return _module(REFERENCES / f"{name}.py", f"bench_reference_{name.replace('.', '_')}")
