"""Resume training from a checkpoint of the port (counterpart of
train_from_checkpoint.py):

    python -m dddpm_tpu_torch.resume_main --checkpoint results/checkpoints/<run> \
        [--steps N] [--data-root PATH] [-mute] [--device cpu]

Rebuilds the trainer from the config stored in the checkpoint and
resumes at the saved step.  Runs on the CUDA card unless --device cpu.
Under torchrun it resumes on a mesh over all N processes, FSDP-sharded
if the run was: a checkpoint holds the one-process layout, so any world
size reads it, and the saved mesh shape is not reused (the JAX entry
reuses it).
"""
import argparse

from dddpm_tpu_torch.parallel.mesh import initialize_distributed, is_main
from dddpm_tpu_torch.train import checkpoint as ckpt
from dddpm_tpu_torch.train.trainer import setup_trainer
from dddpm_tpu_torch.utils import paths

WANDB_PROJECT = "ddpm-test"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True, help="checkpoint directory")
    p.add_argument("--steps", type=int, default=None,
                   help="override total train steps")
    p.add_argument("--data-root", default=paths.DATA_DIR, dest="data_root")
    p.add_argument("-mute", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain PyTorch path)")
    args = p.parse_args(argv)
    initialize_distributed(device=args.device)

    config = ckpt.load_config(args.checkpoint)
    if args.steps is not None:
        config["n_steps"] = args.steps
    if "unet_dims" in config:
        config["unet_dims"] = tuple(config["unet_dims"])
    config["mesh_shape"] = None   # every rank of this run on one data axis

    trainer, config = setup_trainer(config, args.mute, args.data_root,
                                    WANDB_PROJECT, config.get("seed", 0),
                                    device=args.device)
    trainer.load_checkpoint(args.checkpoint)
    if is_main():
        print(f"Resuming {config['model']} at step {trainer.step}")
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
