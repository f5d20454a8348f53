"""The port stands alone: no JAX, no ``wct_tpu``; its CLI and smoke script run."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "wct_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "wct_tpu")


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_imports_without_jax_loaded():
    code = (
        "import sys\n"
        "import wct_tpu_torch.models, wct_tpu_torch.cli.stylize, wct_tpu_torch.ops._build\n"
        "import wct_tpu_torch.tools.profile_convs\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'wct_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def _pngs(tmp_path):
    from wct_tpu_torch.utils import images

    rng = np.random.default_rng(0)
    c_dir, o_dir = tmp_path / "content", tmp_path / "out"
    c_dir.mkdir()
    for i, hw in enumerate([(64, 64), (64, 64), (64, 80)]):
        images.save_img(c_dir / f"c{i}.png", rng.random((*hw, 3)))
    images.save_img(tmp_path / "style.png", rng.random((72, 64, 3)))
    return c_dir, tmp_path / "style.png", o_dir


def test_cli_end_to_end_on_cpu(tmp_path):
    from wct_tpu_torch.cli import stylize
    from wct_tpu_torch.utils import images

    c_dir, style, o_dir = _pngs(tmp_path)
    stylize.main([
        "--weights", str(ROOT / "weights" / "bundle.npz"), "--device", "cpu",
        "--method", "newton_schulz_pallas", "--content-path", str(c_dir),
        "--style-path", str(style), "--out-path", str(o_dir), "--content-size", "64",
        "--batch-size", "2", "--alpha", "0.6",
    ])
    outs = images.get_files(o_dir)
    assert [Path(p).name for p in outs] == ["c0_style.png", "c1_style.png", "c2_style.png"]
    shapes = [images.get_img(p).shape for p in outs]
    assert shapes == [(64, 64, 3), (64, 64, 3), (64, 80, 3)]


def test_cli_random_weights_and_relu_targets(tmp_path):
    from wct_tpu_torch.cli import stylize
    from wct_tpu_torch.utils import images

    c_dir, style, o_dir = _pngs(tmp_path)
    stylize.main([
        "--device", "cpu", "--relu-targets", "relu2_1", "relu1_1", "--method", "auto",
        "--ns-iters", "relu2_1=8", "--content-path", str(c_dir / "c0.png"),
        "--style-path", str(style), "--out-path", str(o_dir),
    ])
    assert len(images.get_files(o_dir)) == 1


def test_cli_and_smoke_refuse_to_run_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from wct_tpu_torch.cli import stylize

    c_dir, style, o_dir = _pngs(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stylize.main(["--content-path", str(c_dir), "--style-path", str(style),
                      "--out-path", str(o_dir)])
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
