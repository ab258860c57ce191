"""Training entry point of the port:

    python -m dddpm_tpu_torch.train_main -m ddpm -d synthetic -e 500 \
        -bs 32 -is 256 -downsample 3 [-mute] [--device cpu]

The flags are train.py's (the JAX entry) without --use-pallas.  Runs on
the CUDA card unless --device cpu is given.  Under torchrun it trains on
a mesh of N processes (one per card; gloo processes with --device cpu),
-bs being the global batch; --fsdp shards the parameters:

    torchrun --nproc-per-node N -m dddpm_tpu_torch.train_main ... [--fsdp]
"""
import json

from dddpm_tpu_torch.config import get_args
from dddpm_tpu_torch.parallel.mesh import initialize_distributed, is_main
from dddpm_tpu_torch.train.trainer import setup_trainer

WANDB_PROJECT = "ddpm-test"


def main(argv=None):
    config, mute = get_args(argv=argv)
    initialize_distributed(device=config.get("device"))
    trainer, config = setup_trainer(
        config, mute, config["data_root"], WANDB_PROJECT,
        config.get("seed", 0), device=config.get("device"))
    if is_main():
        print("\nTraining configuration dict:")
        print(json.dumps({k: str(v) if isinstance(v, tuple) else v
                          for k, v in config.items()}, indent=4) + "\n")
    trainer.train()
    if is_main():
        print("train_main finished!")
    return trainer


if __name__ == "__main__":
    main()
