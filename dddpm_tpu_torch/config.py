"""Training configuration and CLI flags (port of dddpm_tpu/config.py).

The reference's config-dict contract and flags (-m/-d/-e/-bs/-is/-mute/
-downsample) plus the JAX package's --data-root, --T, --compute-dtype,
--seed, --grad-accum, --prefetch, --remat (the UNet's ResnetBlocks
rematerialized under grad, models/unet.py), --mesh-shape and --fsdp
(the mesh over the run's processes and FSDP-style parameter sharding,
parallel/).  The config key fsdp_min_size is read as the JAX package
reads it (default 2**16).  --use-pallas has no counterpart; --device
picks the card (the default) or 'cpu' for the plain PyTorch path.  The JAX
package's two kernel selectors are config keys here as there:
use_pallas_attention ('auto' | True | False, pinned by build_model) and
use_pallas_resample (True | False); False takes the plain path on the
card too.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Tuple

from dddpm_tpu_torch.data.datasets import DATASETS
from dddpm_tpu_torch.utils import paths

MODEL_NAMES = ["ddpm"]

# base config for every model
CONFIG: Dict = {
    "lr": 1e-3,
    "rnd_flip": False,
}

# per-model architecture configs (reference train.py:20-63)
CONFIG_MODEL: Dict[str, Dict] = {
    "ddpm": {
        "lr": 2e-4,                 # iddpm: 2e-4 for 32x32, 2e-5 for 256x256
        "unet_chan": 128,
        "unet_dims": (1, 2, 2, 2),
        "unet_dropout": 0.1,
        "T": 1000,
        "loss_type": "simple",      # simple | vlb | hybrid
        "beta_schedule": "linear",  # linear | cosine
        "ema_decay": 0.995,
        "loss_flat": "sum",         # sum | mean over non-batch loss dims
        "val_split": 0,
    },
    "dddpm": {
        "d_mode": "convolutional_res",  # deterministic | convolutional | convolutional_res
        "u_mode": "convolutional_res",
        "d_dropout": 0,
        "d_chans": 64,
        "d_n_blocks": 3,
        "u_n_blocks": 3,
        "unet_in": 8,
        "ae_loss": True,
        "t_rec_max": 100,
        "force_latent": True,
    },
}

# the port's defaults merged into every run config
CONFIG_PORT: Dict = {
    "compute_dtype": "bfloat16",  # conv / attention compute dtype
    "grad_accum": 2,              # micro-steps per optimizer step
    "mesh_shape": None,           # None -> every rank on one 'data' axis
    "seed": 0,
    # the attention block's kernels (K1a/K1b, or K1c): 'auto' = on when
    # the model is built on a CUDA card (models/factory.py pins it)
    "use_pallas_attention": "auto",
    # the resamplers' fused ConvResBlock kernels (K2/K3)
    "use_pallas_resample": True,
    "prefetch": 2,                # host batch-prep prefetch depth (0 = off)
    "remat": False,               # rematerialize UNet ResnetBlocks under grad
    "fsdp": False,                # shard params/EMA/opt-state over the data axis
    # the AE dDDPM variant's recon branch on the t < t_rec_max rows only
    # (models/dddpm.py:DownsampleDiffusionAutoencoder)
    "recon_compact": True,
}


def parse_mesh_shape(text):
    """'4,2' -> (4, 2); '' / 'none' / None -> None."""
    if text is None or str(text).lower() in ("", "none"):
        return None
    return tuple(int(x) for x in str(text).split(","))


def modify_config(config: Dict, model_config: Dict) -> Dict:
    """Merge model_config into config (reference utils/utils.py:5-8)."""
    config.update(model_config)
    return config


def build_config(args_dict: Dict) -> Dict:
    """The run config from parsed CLI args, with the reference's
    'ddpm' + n_downsamples > 0 -> 'dddpm' rewrite (train.py:71-75)."""
    config = dict(CONFIG)
    config.update(CONFIG_PORT)
    config.update({k: v for k, v in args_dict.items() if k != "mute"})
    config = modify_config(config, dict(CONFIG_MODEL[config["model"]]))
    if config["model"] == "ddpm" and config.get("n_downsamples", 0) > 0:
        config["model"] = "dddpm"
        config = modify_config(config, dict(CONFIG_MODEL["dddpm"]))
    if config.pop("T_override", None):
        config["T"] = args_dict["T_override"]
    return config


def get_args(data_names: List[str] = DATASETS,
             model_names: List[str] = MODEL_NAMES,
             argv=None) -> Tuple[Dict, bool]:
    """Parse CLI args, mirroring the reference flag surface."""
    parser = argparse.ArgumentParser(description="Model training script.")
    parser.add_argument(
        "-m", default=model_names[0], type=str, choices=model_names,
        dest="model", help=f"Pick which model to train (default: {model_names[0]}).")
    parser.add_argument(
        "-d", default=data_names[0], type=str, choices=data_names,
        dest="dataset", help=f"Pick which dataset to fit to (default: {data_names[0]}).")
    parser.add_argument("-e", default=500, type=int, dest="n_steps",
                        help="Number of train steps to perform (default: 500).")
    parser.add_argument("-bs", default=32, type=int, dest="batch_size",
                        help="Batch size of data.")
    parser.add_argument("-is", default=32, type=int, dest="image_size",
                        help="Image size of data.")
    parser.add_argument("-mute", action="store_true",
                        help="Mute progress and logging output.")
    parser.add_argument(
        "-downsample", default=0, type=int, dest="n_downsamples",
        help="How many x2 downsamples to perform. 0 runs standard DDPM.")
    parser.add_argument("--data-root", default=paths.DATA_DIR, type=str,
                        dest="data_root")
    parser.add_argument("--T", default=None, type=int, dest="T_override",
                        help="override the number of diffusion steps T")
    parser.add_argument("--compute-dtype", default="bfloat16", type=str,
                        choices=["bfloat16", "float32"], dest="compute_dtype")
    parser.add_argument("--seed", default=0, type=int, dest="seed")
    parser.add_argument("--grad-accum", default=2, type=int, dest="grad_accum",
                        help="micro-steps per optimizer step")
    parser.add_argument("--mesh-shape", default=None, type=parse_mesh_shape,
                        dest="mesh_shape",
                        help="mesh shape over the run's processes, e.g. '8' "
                             "(default: every rank on one data axis)")
    parser.add_argument("--fsdp", action="store_true",
                        help="FSDP-style parameter sharding over the data axis")
    parser.add_argument("--prefetch", default=2, type=int,
                        help="background host batch-prep depth (0 disables)")
    parser.add_argument("--remat", action="store_true",
                        help="rematerialize UNet ResnetBlocks under grad "
                             "(activation memory for recompute)")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card; 'cpu' "
                             "runs the plain PyTorch path)")
    args = parser.parse_args(argv)
    return build_config(vars(args)), args.mute
