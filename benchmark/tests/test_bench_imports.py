"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: ``wct_tpu_torch`` is the program, ``wct_tpu`` the JAX
package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "wct_tpu"}
RUN_FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", RUN_FILES, ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax_in_what_the_benchmark_runs(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    names = top_level_imports(BENCH / "harness" / "reference.py")
    assert "wct_tpu_torch" not in names and not names & FORBIDDEN
    assert names <= {"__future__", "numpy", "torch"}


def test_whole_names_are_compared():
    sys.path.insert(0, str(BENCH))
    try:
        import run
    finally:
        sys.path.remove(str(BENCH))
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "wct_tpu")
    assert "wct_tpu_torch".split(".")[0] not in run.FORBIDDEN


def test_a_run_loads_no_jax():
    """The harness, the program and the reference in a fresh process, as a
    run loads them (the drivers, the check and the cost model)."""
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]];"
        "import run; from harness import check, drivers, program, reference;"
        "print(run.loaded_forbidden())"
    )
    out = subprocess.run([sys.executable, "-c", code, str(BENCH), str(BENCH.parent)],
                         capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
