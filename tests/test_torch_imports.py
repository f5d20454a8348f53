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
FORBIDDEN = ("jax", "jaxlib", "wct_tpu", "scripts")


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
        "import wct_tpu_torch.utils, wct_tpu_torch.utils.profiling, wct_tpu_torch.utils.serving\n"
        "assert 'PIL' not in sys.modules, 'Pillow loaded without utils.images'\n"
        "import wct_tpu_torch.models, wct_tpu_torch.cli.stylize, wct_tpu_torch.ops._build\n"
        "import wct_tpu_torch.tools.profile_convs, wct_tpu_torch.ops.junction\n"
        "import wct_tpu_torch.tools.profile_sqrtm, wct_tpu_torch.ops.conv_small\n"
        "import wct_tpu_torch.ops.gram, wct_tpu_torch.ops.adain, wct_tpu_torch.ops.style_swap\n"
        "import wct_tpu_torch.utils.colors\n"
        "import wct_tpu_torch.utils.stream, wct_tpu_torch.cli.stream\n"
        "import wct_tpu_torch.train, wct_tpu_torch.train.layerwise, wct_tpu_torch.cli.train\n"
        "import wct_tpu_torch.utils.tb\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'wct_tpu', 'scripts', 'triton', 'cv2')]\n"
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


def test_new_kernel_modules_are_scanned():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"wct_tpu_torch/ops/conv_small.py", "wct_tpu_torch/ops/gram.py",
            "wct_tpu_torch/tools/profile_sqrtm.py", "chip_smoke.py",
            "wct_tpu_torch/ops/adain.py", "wct_tpu_torch/ops/style_swap.py",
            "wct_tpu_torch/utils/colors.py", "wct_tpu_torch/utils/profiling.py",
            "wct_tpu_torch/utils/serving.py", "wct_tpu_torch/utils/stream.py",
            "wct_tpu_torch/cli/stream.py", "wct_tpu_torch/train/trainer.py",
            "wct_tpu_torch/train/data.py", "wct_tpu_torch/train/layerwise.py",
            "wct_tpu_torch/cli/train.py", "wct_tpu_torch/utils/tb.py"} <= names


@pytest.mark.parametrize(
    "kw,item",
    [(dict(compute_dtype="bfloat16", fuse_junction=True), None),
     (dict(compute_dtype="bfloat16", method="newton_schulz_fast", pack2_junction=True), "item 11")],
    ids=["bf16_fuse_junction", "pack2_junction"],
)
def test_options_outside_the_throughput_slice_name_their_roadmap_item(kw, item):
    """An option the port does not carry names its ROADMAP.md item; one it
    carries (``item`` None: bf16 with ``fuse_junction``) builds."""
    from wct_tpu_torch.models import cascade

    if item is None:
        cfg = cascade.CascadeConfig(**kw)
        assert cfg.fuse_junction and cfg.dtype == torch.bfloat16
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1 {item}"):
        cascade.CascadeConfig(**kw)
    roadmap = (ROOT / "ROADMAP.md").read_text()
    assert f"**{item[5:]}." in roadmap or f"{item[5:]}. **" in roadmap


def test_bf16_map_to_a_junction_kernel_names_the_roadmap_item():
    """A bf16 map to a junction kernel is accepted on the CPU and comes
    back bf16."""
    from wct_tpu_torch.models.cascade import init_params
    from wct_tpu_torch.ops import junction

    enc = init_params(0, ("relu1_1",), device="cpu")["encoder"]
    head = [enc[n][k] for n in ("conv0", "conv1_1", "conv1_2") for k in ("w", "b")]
    x = torch.rand(1, 3, 16, 16).to(torch.bfloat16)
    out = junction.encoder_head_nchw(x, *head)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (1, 64, 8, 8)
