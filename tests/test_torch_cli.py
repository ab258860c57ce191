"""The port's command-line pipeline on the CPU, in a scratch directory:
train_main -> resume_main -> generate_main (ancestral, then DDIM) ->
ref_batch_main -> evaluate_main -> compare_main, each through its
main(argv) with --device cpu, on a tiny synthetic x2 dDDPM."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from dddpm_tpu_torch import (
    compare_main,
    evaluate_main,
    generate_main,
    ref_batch_main,
    resume_main,
    train_main,
)
from dddpm_tpu_torch.train import checkpoint as ckpt

TRAIN = ["-d", "synthetic", "-e", "3", "-bs", "4", "-is", "16",
         "-downsample", "1", "--T", "50", "--compute-dtype", "float32",
         "--device", "cpu", "-mute"]


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The scratch directory with a trained and resumed checkpoint."""
    root = tmp_path_factory.mktemp("cli")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        trainer = train_main.main(TRAIN)
        ckpt_dir = trainer.checkpoint_dir
        resumed = resume_main.main(["--checkpoint", ckpt_dir, "--steps", "5",
                                    "-mute", "--device", "cpu"])
        yield root, ckpt_dir, trainer, resumed
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def outputs(ws):
    """The npys of both samplers, the reference batch and both metric
    JSONs, made from inside the scratch directory."""
    root, ckpt_dir, *_ = ws
    name = os.path.basename(os.path.normpath(ckpt_dir))
    cwd = os.getcwd()
    os.chdir(root)
    try:
        common = ["--checkpoint", ckpt_dir, "--batch-size", "4",
                  "--device", "cpu"]
        generate_main.main(common + ["--fid-samples", "4", "--out", "s",
                                     "--latent-out", "sl"])
        generate_main.main(common + ["--fid-samples", "6", "--out", "d",
                                     "--latent-out", "dl", "--ddim-steps", "5"])
        ref = ref_batch_main.main(["-d", "synthetic", "-is", "16", "--n", "8",
                                   "--bs", "4", "--out", "ref"])
        metrics, timing = evaluate_main.main(
            ["--checkpoint", ckpt_dir, "--samples", f"d/{name}.npy",
             "--reference", ref, "--allow-random-inception",
             "--test-batches", "1", "--device", "cpu"])
        same = compare_main.main(["--batch1", ref, "--batch2", ref,
                                  "--allow-random-inception", "--device", "cpu"])
        arrays = {k: np.load(f"{k}/{name}.npy") for k in ("s", "sl", "d", "dl")}
        arrays["ref"] = np.load(ref)
        yield arrays, metrics, timing, same
    finally:
        os.chdir(cwd)


def test_every_entry_reads_the_same_directories(ws, monkeypatch):
    """utils/paths.py holds the defaults of every entry: the data root of
    train_main and the trainer is the one resume_main, evaluate_main and
    ref_batch_main read, and the trainer writes under its checkpoint and
    logging directories."""
    import inspect

    from dddpm_tpu_torch.config import get_args
    from dddpm_tpu_torch.train.trainer import Trainer, setup_trainer
    from dddpm_tpu_torch.utils import paths

    _, ckpt_dir, trainer, resumed = ws
    parent = os.path.dirname(os.path.normpath(ckpt_dir))
    assert os.path.normpath(parent) == os.path.normpath(paths.CHECKPOINT_DIR)
    assert resumed.checkpoint_dir == trainer.checkpoint_dir
    assert trainer.logging_dir == resumed.logging_dir == paths.LOGGING_DIR
    for fn in (Trainer, setup_trainer):
        assert (inspect.signature(fn).parameters["data_root"].default
                == paths.DATA_DIR)
    monkeypatch.setattr(paths, "DATA_DIR", "elsewhere/")
    assert get_args(argv=TRAIN)[0]["data_root"] == "elsewhere/"


def test_resume_continues_the_run(ws):
    _, ckpt_dir, trainer, resumed = ws
    assert trainer.step == 3 and resumed.step == 5
    assert ckpt.load_step(ckpt_dir) == 5
    assert len(resumed.train_losses) == 5
    assert np.isfinite(resumed.train_losses).all()


def test_generate_writes_samples_and_latents(outputs):
    arrays = outputs[0]
    # ancestral: 1 batch of 4; DDIM: 2 batches of 4 for 6 samples
    for k, n in (("s", 1), ("d", 2)):
        assert arrays[k].shape == (n, 4, 16, 16, 3)
        assert arrays[k].dtype == np.float32
        assert np.isfinite(arrays[k]).all()
        assert arrays[k].min() >= 0.0 and arrays[k].max() <= 255.0
        assert arrays[k + "l"].shape == (n, 4, 8, 8, 8)
    assert not np.array_equal(arrays["s"][0], arrays["d"][0])
    assert arrays["ref"].shape == (2, 4, 16, 16, 3)


def test_evaluate_prints_the_metrics(outputs):
    _, metrics, timing, _ = outputs
    assert set(metrics) == {"vlb", "L_simple", "is", "fid", "sfid",
                            "precision", "recall", "inception_weights"}
    assert metrics["inception_weights"] == "random-init"
    for k in ("vlb", "L_simple", "is", "precision", "recall"):
        assert np.isfinite(metrics[k]), k
    assert metrics["vlb"] > 0 and metrics["L_simple"] > 0
    assert timing["test_losses_s"] > 0
    json.dumps(metrics)


def test_compare_identical_batches(outputs):
    same = outputs[3]
    assert abs(same["fid"]) < 1e-3
    assert same["precision"] == 1.0 and same["recall"] == 1.0


def test_evaluate_refuses_without_weights(ws, monkeypatch):
    monkeypatch.delenv("INCEPTION_WEIGHTS_NPZ", raising=False)
    for run, argv in ((evaluate_main.main, ["--checkpoint", ws[1], "--samples",
                                            "a.npy", "--reference", "b.npy"]),
                      (compare_main.main, ["--batch1", "a", "--batch2", "b"])):
        with pytest.raises(SystemExit, match="--allow-random-inception"):
            run(argv)


@pytest.mark.parametrize("ema_decay", [0.0, 0.995])
def test_generate_takes_ema_weights_only_with_an_ema(ws, tmp_path, ema_decay):
    """At ema_decay 0 the entry takes the raw weights, above 0 the EMA
    ones."""
    src = ws[1]
    dst = str(tmp_path / "ckpt")
    shutil.copytree(src, dst)
    config = ckpt.load_config(dst)
    config["ema_decay"] = ema_decay
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(config, f)
    # a run without an EMA keeps its initial weights in the EMA slot: here
    # the slot holds other numbers than the raw weights
    path = os.path.join(dst, "state.pt")
    blob = torch.load(path, weights_only=True)
    blob["ema"] = {k: v * 0.5 + 1.0 for k, v in blob["params"].items()}
    torch.save(blob, path)
    net, _, _ = generate_main.load_eval_model(dst, "cpu")
    want = blob["ema"] if ema_decay > 0 else blob["params"]
    for k, p in net.named_parameters():
        assert torch.equal(p.detach(), want[k]), k


# unet_chan 128 at an 8^2 latent: 14 convs pass the int8 gate
QUANT_CFG = {
    "model": "dddpm", "dataset": "synthetic", "image_size": 16,
    "batch_size": 2, "T": 20, "lr": 1e-3, "loss_type": "simple",
    "beta_schedule": "cosine", "loss_flat": "sum", "unet_chan": 128,
    "unet_dims": (1, 2), "unet_dropout": 0.0, "unet_in": 8,
    "n_downsamples": 1, "d_mode": "convolutional_res",
    "u_mode": "convolutional_res", "d_dropout": 0, "d_chans": 16,
    "d_n_blocks": 1, "u_n_blocks": 1, "ae_loss": True, "t_rec_max": 5,
    "force_latent": True, "compute_dtype": "float32", "ema_decay": 0.0,
}


def test_generate_int8_writes_samples(tmp_path, monkeypatch):
    """generate_main --quant-conv int8 --quant-calib noise on the CPU:
    every amax is calibrated, the samples are finite and differ from the
    float model's from the same seed."""
    from dddpm_tpu_torch.models.blocks import quant_buffers
    from dddpm_tpu_torch.models.factory import build_model
    from dddpm_tpu_torch.train.state import create_optimizer, create_train_state

    net, _, init_fn, config = build_model(QUANT_CFG, device="cpu")
    init_fn(0)
    src = ckpt.save_checkpoint(
        str(tmp_path / "q"),
        create_train_state(net, create_optimizer(net, config["lr"]), seed=0),
        config)
    calibrated = []
    real = generate_main.maybe_calibrate

    def spy(config, net, *args, **kwargs):
        calibrated.append(net)
        return real(config, net, *args, **kwargs)

    monkeypatch.setattr(generate_main, "maybe_calibrate", spy)
    monkeypatch.chdir(tmp_path)
    common = ["--checkpoint", src, "--fid-samples", "2", "--batch-size", "2",
              "--device", "cpu"]
    quant, _, _ = generate_main.main(common + [
        "--quant-conv", "int8", "--quant-calib", "noise",
        "--quant-calib-batch", "2", "--out", "sq", "--latent-out", "slq"])
    assert np.array_equal(np.load("sq/q.npy"), quant)
    plain, _, _ = generate_main.main(common + ["--out", "s", "--latent-out", "sl"])
    bufs = quant_buffers(calibrated[0])
    assert len(calibrated) == 1 and len(bufs) == 14
    assert all(float(b) > 0 for b in bufs.values())
    assert quant.shape == plain.shape == (1, 2, 16, 16, 3)
    assert np.isfinite(quant).all() and not np.array_equal(quant, plain)
