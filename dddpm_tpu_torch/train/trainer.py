"""The training loop (port of dddpm_tpu/train/trainer.py).

Gradient accumulation x2, the optax-rule clip at 1.0, Adam, EMA (start
2000, every 10), per-step 'train_obj' (+ 'train_latent' / 'train_recon'
for dDDPM) logging, checkpoints and sample / recon image grids every
10k steps, the losses JSON at finalize.  Metrics stay device tensors
until the log buffer flushes.  Batches are gathered as uint8 on a
background thread, copied to the card and transformed there.

In a process group (torchrun, parallel/mesh.py) the trainer runs on a
mesh: batch_size is the global batch, every rank reads the same loader
stream and keeps its own rows before the copy to the card; parameters
are replicated (broadcast from rank 0), or FSDP-sharded with config
'fsdp'.  The compact recon branch stays on: in eager PyTorch it forces
no collective, and the mean over ranks of each rank's objective is the
global one.  Rank 0 alone writes the logs, the image grids and the
checkpoints; every rank enters every collective, the checkpoint's and
the preemption handler's included.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import numpy as np
import torch

from dddpm_tpu_torch.data.pipeline import get_dataloader, prefetch, to_float
from dddpm_tpu_torch.models.ddpm import fold_seed
from dddpm_tpu_torch.models.factory import build_model
from dddpm_tpu_torch.ops.math import min_max_norm_image
from dddpm_tpu_torch.parallel import fsdp
from dddpm_tpu_torch.parallel.mesh import (
    batch_sharding,
    broadcast_object,
    create_mesh,
    is_main,
)
from dddpm_tpu_torch.train import checkpoint as ckpt
from dddpm_tpu_torch.train.state import (
    create_optimizer,
    create_train_state,
    make_train_step,
)
from dddpm_tpu_torch.utils import paths
from dddpm_tpu_torch.utils.device import DeviceLike, resolve_device
from dddpm_tpu_torch.utils.logging import RunLogger, generate_run_id
from dddpm_tpu_torch.utils.rng import seed_everything
from dddpm_tpu_torch.utils.timing import StepTimer

SAMPLE_KEY, RECON_KEY = 10_000, 20_000   # fold_seed keys of the eval draws


class Trainer:
    """Step-driven trainer for DDPM and dDDPM models."""

    def __init__(self, config: Dict, mute: bool = False,
                 data_root: str = paths.DATA_DIR,
                 wandb_project: str = "ddpm-test",
                 seed: Optional[int] = 0, workdir: Optional[str] = None,
                 n_samples: int = 25, device: DeviceLike = None):
        self.device = resolve_device(device)
        # mesh: the batch split over 'data'; params replicated, or
        # FSDP-sharded over the data axis when config['fsdp'] is set
        self.mesh = create_mesh(config.get("mesh_shape"))
        self.rows = batch_sharding(self.mesh, config["batch_size"])
        self.is_main = is_main()
        self.seed = broadcast_object(seed_everything(seed), self.mesh)
        self.mute = mute
        # under utils/paths.py's directories unless a workdir is given
        self.logging_dir = (paths.LOGGING_DIR if workdir is None
                            else os.path.join(workdir, "logging"))
        self.project = wandb_project
        self.n_samples = n_samples
        self.n_rows = int(np.sqrt(n_samples))
        if self.n_rows ** 2 != n_samples:
            raise ValueError(f"n_samples ({n_samples}) must be square")
        if n_samples > config["batch_size"]:
            raise ValueError(f"n_samples ({n_samples}) must be <= batch size "
                             f"({config['batch_size']})")
        if config.get("conv_quant"):
            raise ValueError(
                "conv_quant is a sampling/serving-only mode (the "
                "quantized conv path has no VJP — jnp.round's gradient "
                "is zero a.e.); train without it and pass "
                "--quant-conv at generation time")

        # data
        self.train_loader, self.val_loader = get_dataloader(
            config, True, data_root, config.get("val_split", 0),
            seed=seed or 0)

        # model + state
        self.net, self.process, init_fn, config = build_model(config,
                                                              self.device)
        init_fn(self.seed)
        self.config = config
        self.is_downsampled = config["model"] == "dddpm"
        self.name = f"{config['model']}_{config['T']}"
        self.grad_accum = int(config.get("grad_accum", 2))

        self.state = create_train_state(
            self.net, create_optimizer(self.net, config["lr"]), self.seed,
            self.mesh)
        if config.get("fsdp"):
            self.state = fsdp.shard_state_fsdp(
                self.state, self.mesh, min_size=int(config.get(
                    "fsdp_min_size", fsdp.DEFAULT_MIN_SIZE)))
        ema_decay = config.get("ema_decay", 0.995)
        self.use_ema = ema_decay > 0
        self._step_fn = make_train_step(self.process, self.grad_accum,
                                        ema_decay=ema_decay)

        # fixed "val" batch: the first image repeated n_samples times
        # (reference trainer_ddpm.py:21-29; from the train set when
        # val_split == 0), drawn before the prefetch thread starts
        src = self.val_loader if self.val_loader is not None else self.train_loader
        first = next(iter(src))[0][0]
        self.val_batch = torch.from_numpy(
            np.repeat(first[None], n_samples, axis=0)).to(self.device)

        depth = int(config.get("prefetch", 2))
        batches = self._host_batches()
        self._batch_iter = prefetch(batches, depth) if depth > 0 else batches

        # loop bookkeeping
        self.n_steps = config["n_steps"]
        self.logging_every = 10000
        self.flush_every = 200
        self.train_losses = []
        self._metric_buffer = []
        self.run_id = config.get("wandb_id") or broadcast_object(
            generate_run_id(), self.mesh)
        config["wandb_id"] = self.run_id
        self.checkpoint_dir = os.path.join(
            paths.CHECKPOINT_DIR if workdir is None
            else os.path.join(workdir, "checkpoints"),
            f"{self.name}_{self.run_id}")
        self.logger: Optional[RunLogger] = None
        self.timer = StepTimer(
            items_per_step=self.grad_accum * config["batch_size"])

    # ------------------------------------------------------------------ io

    @property
    def step(self) -> int:
        return self.state.step

    @property
    def opt(self):
        return self.state.opt

    def save_checkpoint(self):
        ckpt.save_checkpoint(self.checkpoint_dir, self.state, self.config,
                             self.train_losses)

    def load_checkpoint(self, ckpt_dir: str):
        """Restore state (+ step + losses) from a checkpoint dir."""
        ckpt.restore_checkpoint(ckpt_dir, self.state)
        self.train_losses = ckpt.load_losses(ckpt_dir)

    # ------------------------------------------------------------ sampling

    @contextlib.contextmanager
    def eval_weights(self):
        """The net in eval mode with the EMA weights (when kept), under
        no_grad; the training weights and mode come back after.  Under
        FSDP the sharded ones are gathered (every rank enters) and
        released after."""
        was_training = self.net.training
        layout = self.state.fsdp
        source = self.state.ema_params if self.use_ema else self.state.params
        # the net's own parameters that the EMA overwrites in place
        names = [k for k in self.state.params
                 if layout is None or k not in layout.dims]
        params = [self.state.params[k] for k in names]
        backup = None
        with torch.no_grad():
            if layout is not None:
                fsdp.gather_params(self.state, source)
            if self.use_ema and params:
                backup = [p.detach().clone() for p in params]
                torch._foreach_copy_(params, [source[k] for k in names])
            self.net.eval()
            try:
                yield
            finally:
                if backup is not None:
                    torch._foreach_copy_(params, backup)
                if layout is not None:
                    fsdp.release_params(self.state)
                self.net.train(was_training)

    def sample(self, seed: Optional[int] = None):
        seed = fold_seed(self.seed, SAMPLE_KEY + self.step) if seed is None else seed
        with self.eval_weights():
            return self.process.sample(self.n_samples, seed=seed)

    def recon(self, x, seed: Optional[int] = None):
        seed = fold_seed(self.seed, RECON_KEY + self.step) if seed is None else seed
        with self.eval_weights():
            return self.process.reconstruct(x, self.n_samples, seed=seed)

    def log_images(self):
        """Sample + reconstruction grids, mirroring reference wandb keys."""
        if self.is_downsampled:
            x_sample, z_sample = self.sample()
            x_recon, z_recon = self.recon(self.val_batch)
            images = {"sample": x_sample, "recon": x_recon,
                      "sample_latent": z_sample.mean(-1, keepdim=True),
                      "recon_latent": z_recon.mean(-1, keepdim=True)}
        else:
            images = {"sample": self.sample(),
                      "recon": self.recon(self.val_batch)}
        if self.is_main:
            images = {k: min_max_norm_image(v.float()).cpu().numpy()
                      for k, v in images.items()}
            self.logger.log_images(images, self.step, nrow=self.n_rows)

    # ---------------------------------------------------------------- loop

    def _host_batches(self):
        """Infinite stream of (accum, B, H, W, C) uint8 batches and their
        flip masks, pinned for an asynchronous copy to the card: on a
        mesh, the rank's rows of the global batch."""
        it = self.train_loader.cycle_raw()
        pin = self.device.type == "cuda"
        while True:
            items = [next(it) for _ in range(self.grad_accum)]
            images = torch.from_numpy(np.stack([i[0][self.rows]
                                                for i in items]))
            flips = (None if items[0][1] is None else
                     torch.from_numpy(np.stack([i[1][self.rows]
                                                for i in items])))
            if pin:
                images = images.pin_memory()
            yield images, flips

    def _next_batch(self) -> torch.Tensor:
        images, flips = next(self._batch_iter)
        images = images.to(self.device, non_blocking=True)
        scale, bias = self.train_loader.scale_bias
        shape = images.shape
        x = to_float(images.reshape(-1, *shape[2:]), scale, bias,
                     None if flips is None else flips.reshape(-1))
        return x.reshape(shape)

    def train_step(self) -> Dict[str, torch.Tensor]:
        """One optimizer step on the next batch; the metrics stay on the
        device until the buffer flushes."""
        self.net.train()
        metrics = self._step_fn(self.state, self._next_batch())
        self.timer.mark()
        self._metric_buffer.append(metrics)
        return metrics

    def _flush_metrics(self, upto_step: int):
        for offset, metrics in enumerate(self._metric_buffer):
            step = upto_step - len(self._metric_buffer) + offset + 1
            row = {k: float(v) for k, v in metrics.items()}
            self.train_losses.append(row["train_obj"])
            if self.is_main:
                self.logger.log(row, step)
        self._metric_buffer = []
        if self.is_main:
            self.logger.flush()

    def _install_preemption_handler(self):
        """Checkpoint on SIGTERM/SIGINT, then exit (torchrun signals every
        rank, and each enters the checkpoint's collectives)."""
        import signal

        def handler(signum, frame):
            self._flush_metrics(self.step)
            self.save_checkpoint()
            print(f"caught signal {signum}: checkpoint saved at step "
                  f"{self.step}, exiting")
            raise SystemExit(128 + signum)

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, handler)
            except ValueError:  # not in the main thread
                pass

    def train_loop(self):
        self._install_preemption_handler()
        while self.step < self.n_steps:
            self.train_step()
            step = len(self.train_losses) + len(self._metric_buffer)
            is_log = step != 0 and step % self.logging_every == 0
            if is_log or len(self._metric_buffer) >= self.flush_every:
                self._flush_metrics(step)
            if is_log:
                self.save_checkpoint()
                self.log_images()
                if not self.mute and self.is_main:
                    stats = self.timer.stats()
                    print(f"step {step}: train_obj="
                          f"{self.train_losses[-1]:.4f} "
                          f"imgs/sec={stats.get('items_per_sec', 0):.1f}")

    def init_logging(self):
        if self.is_main:
            self.logger = RunLogger(self.project, self.config,
                                    self.logging_dir,
                                    self.run_id, mute=self.mute)

    def finalize(self):
        self._flush_metrics(self.step)
        self.save_checkpoint()
        if self.is_main:
            self.logger.finish()
        if not self.mute and self.is_main:
            print(f"Training of {self.name} completed!")

    def train(self):
        """init logging -> train_loop -> finalize (reference trainer.py:101)."""
        self.init_logging()
        self.train_loop()
        self.finalize()
        return self.train_losses


def setup_trainer(config: Dict, mute: bool = False,
                  data_root: str = paths.DATA_DIR,
                  wandb_project: str = "ddpm-test", seed: Optional[int] = 0,
                  workdir: Optional[str] = None, n_samples: int = 25,
                  device: DeviceLike = None):
    """Factory mirroring reference trainers/wrapper.py:10-49; runs on the
    card unless device='cpu'."""
    n_samples = min(n_samples, config["batch_size"])
    n_samples = int(np.sqrt(n_samples)) ** 2  # keep it square
    trainer = Trainer(config, mute, data_root, wandb_project, seed, workdir,
                      n_samples=n_samples, device=device)
    return trainer, trainer.config
