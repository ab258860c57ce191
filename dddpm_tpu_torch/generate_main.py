"""Bulk sample generation for FID (counterpart of
generate_model_samples.py):

    python -m dddpm_tpu_torch.generate_main --checkpoint <dir> \
        [--fid-samples 50000] [--batch-size 192] [--out results/samples] \
        [--ddim-steps S [--ddim-eta E]] [--quant-conv int8
        [--quant-calib trajectory|noise] [--quant-calib-batch 4]]
        [--device cpu]

Loads a checkpoint of the port (the EMA weights when the run kept an
EMA, else the raw weights), samples ceil(fid_samples / batch_size)
batches, prints the timing lines of the JAX script and saves the
(n_batches, B, H, W, C) [0, 255] samples npy (and the latent npy for
dDDPM) under the checkpoint's name.  Runs on the CUDA card unless
--device cpu is given.  --quant-conv int8 rebuilds the model in the
W8A8 serving mode (ops/quant.py), loads the same weights and calibrates
the activation scales for this checkpoint (quantize.py) before
sampling.  The JAX script's --chain-segments (a TPU-runtime workaround)
and --prng-impl have no counterpart.

Under torchrun (one process per card) the entry samples on a mesh:
each rank runs B / N rows of every batch, the calibrated activation
scales are rank 0's, and rank 0 prints and writes the same npy files
one process writes:

    torchrun --nproc-per-node N -m dddpm_tpu_torch.generate_main ...
"""
import argparse
import json
import os

import numpy as np

from dddpm_tpu_torch.models.blocks import quant_buffers
from dddpm_tpu_torch.models.factory import build_model
from dddpm_tpu_torch.parallel.mesh import (
    create_mesh,
    initialize_distributed,
    is_main,
    replicate,
)
from dddpm_tpu_torch.quantize import load_float_weights, maybe_calibrate
from dddpm_tpu_torch.sample import generate_samples
from dddpm_tpu_torch.train import checkpoint as ckpt
from dddpm_tpu_torch.utils import paths


def load_eval_model(ckpt_dir: str, device=None, batch_size=None,
                    conv_quant=None):
    """(net, process, config) of a checkpoint, with the weights an
    evaluation takes: the EMA weights when ema_decay > 0, else the raw
    ones (a run without an EMA keeps its initial weights in the EMA
    slot).  conv_quant='int8' builds the model in the int8 serving mode
    on those weights, its activation scales not yet calibrated."""
    config = ckpt.load_config(ckpt_dir)
    if "unet_dims" in config:
        config["unet_dims"] = tuple(config["unet_dims"])
    if batch_size is not None:
        config["batch_size"] = batch_size
    if conv_quant is not None:
        config["conv_quant"] = conv_quant
    net, process, _, config = build_model(config, device)
    load_float_weights(net, ckpt.load_model_params(
        ckpt_dir, prefer_ema=config.get("ema_decay", 0) > 0))
    return net, process, config


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--fid-samples", type=int, default=50000)
    p.add_argument("--batch-size", type=int, default=192)
    p.add_argument("--out", default=paths.SAMPLE_DIR)
    p.add_argument("--latent-out", default=paths.SAMPLE_LATENT_DIR)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ddim-steps", type=int, default=None,
                   help="use strided DDIM sampling with this many steps "
                        "instead of the full ancestral chain")
    p.add_argument("--ddim-eta", type=float, default=0.0)
    p.add_argument("--quant-conv", default="none", choices=["none", "int8"],
                   help="opt-in W8A8 quantized conv serving mode "
                        "(ops/quant.py): the 3x3 convs the JAX package's "
                        "shape gate admits run as s8 convs with calibrated "
                        "activation scales. Changes numerics (int8 "
                        "rounding); default off")
    p.add_argument("--quant-calib", default="trajectory",
                   choices=["trajectory", "noise"],
                   help="activation-scale calibration: 'trajectory' runs "
                        "a reverse chain with quantization off and observes "
                        "real chain states (the default); 'noise' observes "
                        "N(0,1) latents only (cheap bootstrap)")
    p.add_argument("--quant-calib-batch", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain PyTorch path)")
    args = p.parse_args(argv)
    initialize_distributed(device=args.device)
    mesh = create_mesh()
    say = print if is_main() else (lambda *a, **k: None)

    quant = None if args.quant_conv == "none" else args.quant_conv
    net, process, config = load_eval_model(args.checkpoint, args.device,
                                           args.batch_size, quant)
    if quant is not None:
        maybe_calibrate(config, net, process,
                        batch_size=args.quant_calib_batch,
                        mode=args.quant_calib, seed=args.seed + 1)
        # every rank quantizes with rank 0's scales
        replicate(quant_buffers(net).values(), mesh)
        say(f"conv_quant={args.quant_conv}: activation scales "
            f"calibrated ({args.quant_calib} mode)")
    step = ckpt.load_step(args.checkpoint)

    name = os.path.basename(os.path.normpath(args.checkpoint))
    say(f"\nGenerating {args.fid_samples} samples from checkpoint {name}.")
    say(f"Trained for {step} steps with configuration dict:")
    say(json.dumps({k: str(v) if isinstance(v, tuple) else v
                    for k, v in config.items()}, indent=4) + "\n")

    samples, latents, timing = generate_samples(
        process, args.seed, args.fid_samples, args.batch_size,
        ddim_steps=args.ddim_steps, ddim_eta=args.ddim_eta,
        progress=is_main(), mesh=mesh)

    say(f"Using batch size {args.batch_size}")
    say(f"Total time: {timing['total_s']}")
    say(f"Sample time: {timing['per_sample_s']}")
    say(f"Batch time: {timing['per_batch_s']}")
    say(f"Throughput: {timing['imgs_per_sec']:.2f} imgs/sec")
    if not is_main():
        return samples, latents, timing

    os.makedirs(args.out, exist_ok=True)
    save_path = os.path.join(args.out, name)
    np.save(save_path, samples, allow_pickle=False)
    print(f"Samples saved to {save_path}")

    if latents is not None:
        os.makedirs(args.latent_out, exist_ok=True)
        save_path = os.path.join(args.latent_out, name)
        np.save(save_path, latents, allow_pickle=False)
        print(f"Latent samples saved to {save_path}")
    return samples, latents, timing


if __name__ == "__main__":
    main()
