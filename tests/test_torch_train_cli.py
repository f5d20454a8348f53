"""The port's training CLI on the CPU, mirroring ``tests/test_cli.py``'s
train cases; its training state in ``wct_tpu``'s layout."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from wct_tpu_torch.cli import train as cli
from wct_tpu_torch.train import checkpoint as tck
from wct_tpu_torch.utils import images

ROOT = Path(__file__).resolve().parent.parent
BUNDLE = str(ROOT / "weights" / "bundle.npz")
SMALL = ["--relu-target", "relu1_1", "--synthetic", "--batch-size", "2", "--crop-size", "32",
         "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers, and torch's OpenMP threads spinning on a loaded
    machine made a 30-step test take 150 s instead of 1."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rows(ckpt):
    return [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]


def test_train_cli_synthetic_writes_reference_files(tmp_path):
    ckpt = tmp_path / "ckpt"
    cli.main(SMALL + ["--checkpoint-dir", str(ckpt), "--max-iter", "4", "--save-iter", "4",
                      "--summary-iter", "2"])
    rows = _rows(ckpt)
    assert [r["step"] for r in rows] == [2, 4]
    assert set(rows[0]) == {"loss", "pixel", "feature", "tv", "step", "img_per_sec"}
    assert all(np.isfinite(r["loss"]) for r in rows)
    state = tck.load_pytree(ckpt / "state_latest.npz")
    assert int(state["step"]) == 4 and int(state["opt_state"][0][0]) == 4
    dec = tck.load_pytree(ckpt / "decoder_relu1_1.npz")
    assert dec["dec_conv1_1"]["w"].shape == (3, 3, 64, 3)  # the JAX package's HWIO


def test_train_cli_val_path_and_tensorboard_absent(tmp_path, monkeypatch, capsys):
    """Validation metrics and PNGs; ``--tensorboard`` without TensorBoard
    is a no-op. (Importing TensorBoard here loads TensorFlow, tens of
    seconds, so the writer's absence is simulated.)"""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    rng = np.random.default_rng(0)
    val_dir = tmp_path / "val"
    val_dir.mkdir()
    for i in range(2):
        images.save_img(val_dir / f"v{i}.png", rng.random((40, 40, 3)))
    ckpt = tmp_path / "ckpt"
    cli.main(SMALL + ["--val-path", str(val_dir), "--checkpoint-dir", str(ckpt),
                      "--max-iter", "2", "--save-iter", "2", "--summary-iter", "2",
                      "--tensorboard"])
    rows = _rows(ckpt)
    assert {"val_loss", "val_pixel", "val_feature", "val_tv"} <= set(rows[0])
    assert sorted(p.name for p in ckpt.glob("val_recon_*_step*.png")) == [
        "val_recon_0_step2.png", "val_recon_1_step2.png"]
    assert "tensorboard requested but unavailable" in capsys.readouterr().out
    assert not (ckpt / "tb").exists()
    from wct_tpu_torch.utils.tb import SummaryWriter

    writer = SummaryWriter(tmp_path / "tb")
    assert not writer.active
    writer.scalars(1, {"loss": 1.0})
    writer.images(1, "x", np.zeros((1, 4, 4, 3)))
    writer.close()


def test_train_cli_pool_resume_continues_the_batch_stream(tmp_path):
    """A run stopped at step 2 and resumed to 4 ends in the bits of one
    uninterrupted run to 4: the pool's batches depend on (seed, step)."""
    common = SMALL + ["--synthetic-pool", "6", "--save-iter", "2", "--summary-iter", "2"]
    cli.main(common + ["--checkpoint-dir", str(tmp_path / "a"), "--max-iter", "2"])
    cli.main(common + ["--checkpoint-dir", str(tmp_path / "a"), "--max-iter", "4", "--resume"])
    cli.main(common + ["--checkpoint-dir", str(tmp_path / "b"), "--max-iter", "4"])
    assert [r["step"] for r in _rows(tmp_path / "a")] == [2, 4]
    a = tck._flatten(tck.load_pytree(tmp_path / "a" / "state_latest.npz"))
    b = tck._flatten(tck.load_pytree(tmp_path / "b" / "state_latest.npz"))
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_cli_state_has_the_reference_layout(tmp_path):
    """The CLI's ``state_latest.npz`` has exactly the keys, shapes and
    dtypes ``wct_tpu``'s CLI writes, and ``wct_tpu``'s resume rebuilds
    its optax state from it (``wct_tpu/cli/train.py:160-174``); stepping
    across packages is ``tests/test_torch_train_optim.py``'s."""
    import jax
    import jax.numpy as jnp

    from wct_tpu.train import checkpoint as jck
    from wct_tpu.train import trainer as jt

    ckpt = tmp_path / "ckpt"
    cli.main(SMALL + ["--encoder-weights", BUNDLE, "--checkpoint-dir", str(ckpt),
                      "--max-iter", "2", "--save-iter", "2", "--summary-iter", "2"])
    cfg = jt.TrainConfig(relu_target="relu1_1", batch_size=2, crop_size=32)
    params = jt.init_train_state(jax.random.PRNGKey(0), cfg).params
    ref = jck._flatten(jax.device_get({"params": params,
                                       "opt_state": jt.make_optimizer(cfg).init(params),
                                       "step": jnp.int32(0)}))
    tree = jck.load_pytree(ckpt / "state_latest.npz")
    ours = jck._flatten(jax.device_get(tree))
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].shape == v.shape and ours[k].dtype == v.dtype, k
    opt_state = jax.tree.unflatten(jax.tree.structure(jt.make_optimizer(cfg).init(tree["params"])),
                                   jax.tree.leaves(tree["opt_state"]))
    assert int(opt_state[0].count) == int(opt_state[1].count) == int(tree["step"]) == 2


def test_train_cli_init_decoder_and_resume_precedence(tmp_path):
    tree = tck.load_pytree(BUNDLE)
    init = tmp_path / "solved.npz"
    tck.save_pytree(init, {"relu1_1": tree["decoders"]["relu1_1"]})
    ckpt = tmp_path / "ckpt"
    args = SMALL + ["--encoder-weights", BUNDLE, "--checkpoint-dir", str(ckpt),
                    "--init-decoder", str(init), "--learning-rate", "0", "--save-iter", "1",
                    "--summary-iter", "1"]
    cli.main(args + ["--max-iter", "1"])
    dec = tck._flatten(tck.load_pytree(ckpt / "decoder_relu1_1.npz"))
    for k, v in tck._flatten(tree["decoders"]["relu1_1"]).items():
        np.testing.assert_array_equal(dec[k], v, err_msg=k)  # lr 0: the init itself
    cli.main(args + ["--max-iter", "2", "--resume"])
    assert [r["step"] for r in _rows(ckpt)] == [1, 2]


def test_train_cli_unported_options_name_their_roadmap_items(tmp_path):
    """``--data-parallel`` (ROADMAP.md queue 1 item 10) and ``--ckpt-format
    orbax`` (item 12) are carried. On the CPU, a mesh of one,
    ``--data-parallel`` trains as without it, and the step-directory
    backend as the npz one: the same decoder bits. The orbax run keeps
    its ``--ckpt-keep`` last steps."""
    decs = []
    for i, extra in enumerate(([], ["--data-parallel"],
                               ["--ckpt-format", "orbax", "--ckpt-keep", "1"])):
        ckpt = tmp_path / f"dp{i}"
        cli.main(SMALL + ["--checkpoint-dir", str(ckpt), "--max-iter", "2", "--save-iter", "1",
                          "--summary-iter", "1", "--synthetic-pool", "4", *extra])
        decs.append(tck._flatten(tck.load_pytree(ckpt / "decoder_relu1_1.npz")))
    for dec in decs[1:]:
        for k, v in decs[0].items():
            np.testing.assert_array_equal(dec[k], v, err_msg=k)
    assert [p.name for p in (tmp_path / "dp2" / "orbax").iterdir()] == ["2"]


def test_train_cli_save_on_signal(tmp_path):
    """SIGTERM mid-run → checkpoint, exit 0, and the state resumes."""
    ckpt = tmp_path / "ckpt"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "wct_tpu_torch.cli.train", *SMALL, "--checkpoint-dir", str(ckpt),
         "--max-iter", "100000", "--save-iter", "100000", "--summary-iter", "5"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        deadline = time.time() + 120
        metrics = ckpt / "metrics.jsonl"
        while time.time() < deadline and not (metrics.exists() and metrics.read_text()):
            time.sleep(0.2)
            if proc.poll() is not None:
                raise AssertionError(f"train exited early:\n{proc.stdout.read()}")
        assert metrics.exists(), "training never reached a summary step"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "checkpointing and stopping" in out
    step = int(tck.load_pytree(ckpt / "state_latest.npz")["step"])
    assert step >= 5
    cli.main(SMALL + ["--checkpoint-dir", str(ckpt), "--max-iter", str(step + 1), "--resume",
                      "--summary-iter", "1", "--save-iter", "100000"])
    assert _rows(ckpt)[-1]["step"] == step + 1


def test_trained_decoder_loads_into_stylize(tmp_path):
    from wct_tpu_torch.cli import stylize

    ckpt = tmp_path / "ckpt"
    cli.main(SMALL + ["--encoder-weights", BUNDLE, "--checkpoint-dir", str(ckpt),
                      "--max-iter", "2", "--save-iter", "2"])
    bundle = tmp_path / "bundle.npz"
    tck.save_pytree(bundle, {"encoder": tck.load_pytree(BUNDLE)["encoder"],
                             "decoders": {"relu1_1": tck.load_pytree(
                                 ckpt / "decoder_relu1_1.npz")}})
    c_dir = tmp_path / "content"
    c_dir.mkdir()
    images.save_img(c_dir / "c.png", np.random.default_rng(1).random((32, 32, 3)))
    o_dir = tmp_path / "out"
    stylize.main(["--weights", str(bundle), "--content-path", str(c_dir), "--style-path",
                  str(c_dir), "--out-path", str(o_dir), "--relu-targets", "relu1_1",
                  "--device", "cpu"])
    [out] = images.get_files(o_dir)
    assert np.isfinite(images.get_img(out)).all()


def test_train_cli_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--synthetic", "--checkpoint-dir", str(tmp_path)])
