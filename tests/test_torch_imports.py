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
FORBIDDEN = ("jax", "jaxlib", "orbax", "wct_tpu", "scripts")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers, and torch's OpenMP threads spinning on a loaded
    machine made a 30-step test take 150 s instead of 1."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


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


def test_eval_and_tool_modules_are_scanned():
    """The evaluation package, the offline tools and the pack2 ops are
    among the files the import scan reads."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"wct_tpu_torch/eval/__init__.py", "wct_tpu_torch/eval/frozen.py",
            "wct_tpu_torch/eval/texture.py", "wct_tpu_torch/tools/t7_reader.py",
            "wct_tpu_torch/tools/convert_t7.py", "wct_tpu_torch/tools/convert_tf_ckpt.py",
            "wct_tpu_torch/tools/normalize_encoder.py", "wct_tpu_torch/tools/compare_outputs.py",
            "wct_tpu_torch/tools/oracle.py", "wct_tpu_torch/ops/pack2.py"} <= names


def test_eval_and_tools_import_without_jax_orbax_or_tensorflow():
    code = (
        "import sys\n"
        "import wct_tpu_torch.eval, wct_tpu_torch.ops.pack2, wct_tpu_torch.tools.oracle\n"
        "import wct_tpu_torch.tools.convert_t7, wct_tpu_torch.tools.convert_tf_ckpt\n"
        "import wct_tpu_torch.tools.normalize_encoder, wct_tpu_torch.tools.compare_outputs\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'orbax', 'wct_tpu', 'tensorflow', 'triton')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


@pytest.mark.parametrize(
    "kw",
    [dict(compute_dtype="bfloat16", fuse_junction=True),
     dict(compute_dtype="bfloat16", method="newton_schulz_fast", pack2_junction=True)],
    ids=["bf16_fuse_junction", "pack2_junction"],
)
def test_options_outside_the_throughput_slice_name_their_roadmap_item(kw):
    """Both configs build. pack2 on an even batch in ``stylize_spatial``,
    the last option the port refused (ROADMAP.md item 11h), runs on two
    CPU shards within 1e-4 of the call without it (measured: the same
    bits); an odd batch runs there unpacked."""
    import dataclasses

    from wct_tpu_torch.models import cascade
    from wct_tpu_torch.parallel import mesh

    cfg = cascade.CascadeConfig(**kw)
    assert cfg.dtype == torch.bfloat16
    if not cfg.pack2_junction:
        assert cfg.fuse_junction
        return
    params = cascade.init_params(0, ("relu1_1",), device="cpu")
    cfg = cascade.CascadeConfig(relu_targets=("relu1_1",), **kw)
    style = np.random.default_rng(0).random((16, 16, 3), np.float32)
    cache = cascade.precompute_style(params["encoder"], style, cfg)
    sp = mesh.create_mesh(2, axis_name="sp", device="cpu")
    content = np.random.default_rng(1).random((2, 32, 16, 3), np.float32)
    on = mesh.stylize_spatial(params, content, cache, 0.6, cfg, sp)
    off = mesh.stylize_spatial(params, content, cache, 0.6,
                               dataclasses.replace(cfg, pack2_junction=False), sp)
    assert on.shape == (2, 32, 16, 3) and bool(torch.isfinite(on).all())
    assert float((on - off).abs().max()) <= 1e-4
    assert mesh.stylize_spatial(params, content[:1], cache, 0.6, cfg, sp).shape == (1, 32, 16, 3)


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
