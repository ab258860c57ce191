"""Converts a checkpoint of the JAX package into one of the PyTorch port.

    python convert_jax_checkpoint.py --checkpoint results/checkpoints/<run> \
        --out <port run dir>

Reads the orbax checkpoint and its config.json through
dddpm_tpu.train.checkpoint (the JAX model rebuilt from that config gives
the state's structure), maps the parameters, the EMA weights and the
Adam moments (optax's mu / nu and count -> torch.optim.Adam's exp_avg /
exp_avg_sq and step) with dddpm_tpu_torch.convert.jax_to_state_dict,
and writes the port's state.pt, config.json and train_losses.json, which
dddpm_tpu_torch.generate_main, evaluate_main and resume_main read.  The
port's seed is the config's 'seed' (0 when absent), as resume_main
takes it: the JAX run's PRNG key has no counterpart.

This file is the one part of the port that imports the JAX package
(and so JAX and orbax); it lives outside dddpm_tpu_torch/, which never
does, and changes nothing of the JAX package.  It runs on the CPU.
Set DDDPM_PLATFORM=cpu where the JAX install would pick another
backend.
"""
import argparse
import os

import numpy as np
import jax
import torch

from dddpm_tpu.utils.platform import maybe_force_platform

maybe_force_platform()

from dddpm_tpu.models.factory import build_model as jax_build_model  # noqa: E402
from dddpm_tpu.train import checkpoint as jax_ckpt  # noqa: E402
from dddpm_tpu.train.state import create_optimizer as jax_create_optimizer  # noqa: E402
from dddpm_tpu.train.state import create_train_state as jax_create_train_state  # noqa: E402
from dddpm_tpu_torch.convert import jax_to_state_dict  # noqa: E402
from dddpm_tpu_torch.models.factory import build_model  # noqa: E402
from dddpm_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from dddpm_tpu_torch.train.state import TrainState, create_optimizer  # noqa: E402


def _numpy(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _adam_state(opt_state):
    """The ScaleByAdamState of the optimizer chain (clip, then Adam)."""
    found = [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu") and hasattr(s, "nu"))
        if hasattr(s, "mu")]
    if len(found) != 1:
        raise ValueError(f"expected one Adam state in the optimizer state, "
                         f"found {len(found)}")
    return found[0]


def load_jax_state(ckpt_dir: str):
    """(config, TrainState) of a JAX checkpoint, on the CPU."""
    config = jax_ckpt.load_config(ckpt_dir)
    if "unet_dims" in config:
        config["unet_dims"] = tuple(config["unet_dims"])
    _, _, init_fn, jcfg = jax_build_model(config)
    tx = jax_create_optimizer(jcfg["lr"])
    abstract = jax.eval_shape(
        lambda r: jax_create_train_state(jcfg, init_fn, r, tx),
        jax.random.PRNGKey(0))
    return config, jax_ckpt.restore_checkpoint(ckpt_dir, abstract)


def convert(ckpt_dir: str, out_dir: str) -> str:
    """Writes the port's checkpoint of the JAX checkpoint `ckpt_dir`
    under `out_dir`; returns out_dir's absolute path."""
    config, state = load_jax_state(ckpt_dir)
    net, _, _, pcfg = build_model(config, device="cpu")
    names = [name for name, _ in net.named_parameters()]

    def by_name(tree) -> dict:
        sd = jax_to_state_dict(_numpy(tree), net)
        return {k: sd[k] for k in names}

    net.load_state_dict(jax_to_state_dict(_numpy(state.params), net))
    adam = _adam_state(state.opt_state)
    mu, nu = by_name(adam.mu), by_name(adam.nu)
    opt = create_optimizer(net, pcfg["lr"])
    opt_sd = opt.state_dict()
    count = torch.tensor(float(np.asarray(adam.count)))
    # torch.optim.Adam keys its state by the index in net.parameters()
    opt_sd["state"] = {i: {"step": count.clone(), "exp_avg": mu[n],
                           "exp_avg_sq": nu[n]} for i, n in enumerate(names)}
    opt.load_state_dict(opt_sd)
    tstate = TrainState(step=int(np.asarray(state.step)),
                        params=dict(net.named_parameters()),
                        ema_params=by_name(state.ema_params), opt=opt,
                        seed=int(config.get("seed", 0)))
    return ckpt.save_checkpoint(out_dir, tstate, pcfg,
                                jax_ckpt.load_losses(ckpt_dir))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True,
                   help="the JAX package's checkpoint directory")
    p.add_argument("--out", required=True,
                   help="directory of the port's checkpoint to write")
    args = p.parse_args(argv)
    out = convert(args.checkpoint, args.out)
    print(f"converted {os.path.abspath(args.checkpoint)} -> {out}")
    return out


if __name__ == "__main__":
    main()
