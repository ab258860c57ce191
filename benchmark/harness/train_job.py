"""The training job: `make_train_step`'s step (gradient accumulation,
the clip, Adam, the EMA) of the AE dDDPM at the traffic's batch, step
after step for as long as the window lasts.

Set-up builds one train state and drives it through its first steps,
each through the window's own call and feed; the check follows the
first three with the reference.  Every step's batch, t and eps come
from the seed: images uniform in [-1, 1] on the device, eps N(0, 1) on
the device, t on the host (so the program reads the recon gate without
a sync).  The number of rows under the recon gate (t < t_rec_max) in
each micro-batch follows the traffic's `recon_rows`, in an order drawn
from the seed: every seed trains on the same set of sizes, and set-up
takes one whole period of them, so that no size is new in the window.

The program draws its own dropout masks (the contracting path's
ResnetBlocks); forward hooks on its dropout modules read them in the
checked steps, packed to bits on the host, and hand them to the
reference.  The hooks are gone before the window.

With --trace 1 the device trace covers one whole period of the recon
sizes, each step closed by a synchronize and a marker, so that each
untraced step's device time is that of the traced step with its sizes.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

import torch

from benchmark.harness import common, flops as model_flops, seeds, weights
from benchmark.harness.trace import mark, traced
from benchmark.reference import compare
from benchmark.reference.diffusion import Reference, train_readings
from benchmark.reference.precision import full_f32

CHECKED_STEPS = 3


class TrainJob:
    kind = "train"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.batch = int(traffic["batch_size"])
        self.accum = int(config["grad_accum"])
        counts = list(traffic["recon_rows"])
        gen = torch.Generator().manual_seed(seeds.mix(seed, seeds.ORDER))
        self.rows = [counts[int(k)] for k in torch.randperm(len(counts),
                                                            generator=gen)]
        self.masks = None   # the program's dropout masks, checked steps
        # steps after which the recon sizes repeat
        self.period = len(counts) // math.gcd(len(counts), self.accum)

    # ----------------------------------------------------------------- feed

    def recon_rows(self, step: int) -> List[int]:
        return [self.rows[(step * self.accum + m) % len(self.rows)]
                for m in range(self.accum)]

    def feed(self, step: int):
        """(batch (A, B, H, W, 3), t (A, B) on the host, eps (A, B, h, w, c))."""
        cfg, a, b = self.config, self.accum, self.batch
        size, zs = cfg["image_size"], cfg["image_size"] // 2 ** cfg["n_downsamples"]
        x = torch.rand((a, b, size, size, 3), device=self.device,
                       generator=seeds.generator(self.device, self.seed, step, 0))
        x = x * 2.0 - 1.0
        eps = torch.randn((a, b, zs, zs, cfg["unet_in"]), device=self.device,
                          generator=seeds.generator(self.device, self.seed, step, 1))
        gen = seeds.generator("cpu", self.seed, step, 2)
        t_max, t_rec = cfg["T"], cfg["t_rec_max"]
        ts = []
        for r in self.recon_rows(step):
            t = torch.cat([torch.randint(0, t_rec, (r,), generator=gen),
                           torch.randint(t_rec, t_max, (b - r,), generator=gen)])
            ts.append(t[torch.randperm(b, generator=gen)])
        return x, torch.stack(ts), eps

    # --------------------------------------------------------------- set-up

    def setup(self, fault: Optional[str] = None) -> None:
        """Builds the state and takes the first steps; `fault` (tests
        only) is planted before them, see `plant`."""
        from dddpm_tpu_torch.models.factory import build_model
        from dddpm_tpu_torch.train.state import (create_optimizer,
                                                 create_train_state,
                                                 make_train_step)

        t0 = common.now()
        cfg = dict(self.config, batch_size=self.batch)
        self.net, self.process, _, _ = build_model(cfg, self.device)
        self.net.train()
        t1 = common.now()
        self.start = weights.draw(self.config, self.seed, self.device)
        weights.load_into(self.net, self.start)
        common.sync(self.device)
        t2 = common.now()
        self.opt = create_optimizer(self.net, cfg["lr"])
        self.state = create_train_state(self.net, self.opt, self.seed)
        self.step_fn = make_train_step(self.process, self.accum,
                                       ema_decay=cfg["ema_decay"])
        plant(self, fault)
        params = dict(self.net.named_parameters())
        self.readings = {"losses": []}
        drawn: list = []
        hooks = watch_dropout(self.net, drawn)
        # the warm-up takes every recon size (a shape of its own) once
        warm = max(CHECKED_STEPS, self.period)
        for s in range(warm):
            metrics = self.step_fn(self.state, *self.feed(s))
            if s < CHECKED_STEPS:
                self.readings["losses"].append(float(metrics["train_obj"]))
            if s == 0:
                adam = self.opt.adam.state
                self.readings["grad_norms"] = {   # no state: no gradient
                    n: (float(adam[p]["exp_avg"].norm()) / (1 - 0.9)
                        if "exp_avg" in adam.get(p, {}) else 0.0)
                    for n, p in params.items()}
            if s == CHECKED_STEPS - 1:
                ema = self.state.ema_params
                self.readings["change"] = {
                    n: (float((p.detach() - self.start[n]).norm()),
                        float((ema[n] - self.start[n]).norm()))
                    for n, p in params.items()}
                for h in hooks:
                    h.remove()
                self.masks = split_masks(drawn, len(hooks), self.accum,
                                         CHECKED_STEPS)
        self.next_step = s + 1
        self.start = None   # the check draws the weights again
        common.sync(self.device)
        self.phases = {"model": t1 - t0, "weights": t2 - t1,
                       "first steps": common.now() - t2}

    # --------------------------------------------------------------- window

    def window(self, seconds: float, trace: bool) -> Dict:
        rec = common.Record(self.kind, self.config, self.traffic, self.batch)
        common.sync(self.device)
        s = self.next_step
        if trace:   # one period of the recon sizes, a step between marks
            before, out = common.launches(), []
            with traced(out):
                for s in range(s, s + self.period):
                    self.step_fn(self.state, *self.feed(s))
                    rec.traced_rows += self.recon_rows(s)
                    common.sync(self.device)
                    mark()
                common.sync(self.device)
            rec.traced, rec.traced_steps = out[0], self.period
            rec.traced_launches = common.delta(common.launches(), before)
            first_traced = s + 1 - self.period
            rec.busy_by_key = {(first_traced + k) % self.period: busy
                               for k, busy in enumerate(rec.traced.step_busy())}
            s += 1
            with traced(out, host=True):   # one step, for the idle gaps
                self.step_fn(self.state, *self.feed(s))
                common.sync(self.device)
            rec.host_traced = out[1]
            s += 1
        first = s
        t0 = common.now()
        while common.now() - t0 < seconds:
            t_step = common.now()
            self.step_fn(self.state, *self.feed(s))
            s += 1
            if trace:   # each step closed by a synchronize
                common.sync(self.device)
                rec.step_times.append(common.now() - t_step)
        common.sync(self.device)
        rec.steps, rec.seconds = s - first, common.now() - t0
        rec.window_keys = [st % self.period for st in range(first, s)]
        if trace:
            f = model_flops.per_image(self.config)
            rec.flops = sum(self.batch * (f["down_fwd"] + f["unet_train"])
                            + r * f["recon_train"]
                            for st in range(first, s)
                            for r in self.recon_rows(st))
        imgs = rec.steps * self.accum * self.batch
        return {"rate": imgs / rec.seconds, "steps": s - self.next_step,
                "record": rec}

    def release(self) -> None:
        self.net = self.process = self.state = self.opt = self.step_fn = None
        self.start = None
        common.free(self.device)

    # ---------------------------------------------------------------- check

    def _feeds(self, steps: int):
        for s in range(steps):
            x, t, eps = self.feed(s)
            yield (list(x.unbind(0)), list(t.unbind(0)), list(eps.unbind(0)),
                   self.masks[s] if self.masks else None)

    def check(self, precs: Iterable[str] = (),
              faults: Iterable[str] = ()) -> Dict[str, Dict[str, float]]:
        """The numbers compared, {'program': ...}, and the same numbers of
        the reference at each of `precs`, and with each of `faults`
        planted, put in the program's place."""
        rows = int(self.traffic["reference_rows"])
        lr = self.config["lr"]
        if self.masks and any(bits.shape[0] != self.batch
                              for step in self.masks for micro in step
                              for bits, _ in micro.values()):
            # the program's network did not see every row of its batch
            self.worst_leaves = {}
            return {"program": dict.fromkeys(compare.TRAIN_NUMBERS,
                                             float("inf"))}

        def readings(prec="f32", fault=None):
            ref = Reference(self.config, weights.draw(self.config, self.seed,
                                                      self.device),
                            self.device, prec=prec, rows=rows)
            return train_readings(ref, self._feeds(CHECKED_STEPS), lr, fault)

        with full_f32():
            want = readings()
            names = want["names"]
            got = {"losses": self.readings["losses"],
                   "grad_norms": [self.readings["grad_norms"][n] for n in names],
                   "change_norms": ([self.readings["change"][n][0] for n in names]
                                    + [self.readings["change"][n][1] for n in names])}
            out = {"program": compare.train_gaps(got, want)}
            keep = [True] * len(names)
            self.worst_leaves = {
                kind: sorted(zip(compare.leaf_gaps(got[k], want[k], keep * m),
                                 [n + suffix for suffix in sfx for n in names]),
                             reverse=True)[:4]
                for kind, k, m, sfx in (("grad", "grad_norms", 1, [""]),
                                        ("change", "change_norms", 2,
                                         ["", " (ema)"]))}
            for p in precs:
                out[p] = compare.train_gaps(readings(prec=p), want)
            for f in faults:
                out[f] = compare.train_gaps(readings(fault=f), want)
        return out


def watch_dropout(net: torch.nn.Module, drawn: list) -> list:
    """Forward hooks on the net's dropout modules that drop; each call
    appends (the block's name, (its mask packed to bits on the host,
    (C, H, W))) to `drawn`, the form `Reference.set_masks` reads.  A kept
    element is one the module's output keeps; where the input was 0
    already, the mask cannot be read and the element counts as kept."""
    hooks = []
    for name, m in net.named_modules():
        if isinstance(m, torch.nn.Dropout) and m.p > 0:
            block = name.rsplit(".", 1)[0]

            def hook(mod, inputs, out, block=block):
                kept = (out != 0) | (inputs[0] == 0)
                drawn.append((block, (pack_bits(kept), tuple(kept.shape[1:]))))
            hooks.append(m.register_forward_hook(hook))
    return hooks


def pack_bits(kept: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) bool as uint8 (B, C * H * W / 8), eight consecutive
    NCHW elements a byte, the lowest bit first, copied to the host."""
    rows = kept.reshape(kept.shape[0], -1, 8).to(torch.uint8)
    shifts = torch.arange(8, device=kept.device, dtype=torch.uint8)
    bits = (rows << shifts).sum(-1, dtype=torch.uint8)
    host = torch.empty(bits.shape, dtype=torch.uint8,
                       pin_memory=bits.device.type == "cuda")
    return host.copy_(bits, non_blocking=True)


def split_masks(drawn: list, per_call: int, accum: int, steps: int):
    """`drawn` as [step][micro-batch] {block: mask}; None without dropout."""
    if not per_call:
        return None
    if len(drawn) != per_call * accum * steps:
        raise RuntimeError(f"{len(drawn)} dropout calls in {steps} steps; "
                           f"expected {per_call * accum * steps}")
    calls = [dict(drawn[i:i + per_call])
             for i in range(0, len(drawn), per_call)]
    if any(len(c) != per_call for c in calls):
        raise RuntimeError("a micro-batch did not call each dropout once")
    return [calls[s * accum:(s + 1) * accum] for s in range(steps)]


def plant(job: TrainJob, fault: Optional[str]) -> None:
    """Breaks the timed path underneath the job, for the test that the
    check catches it: 'unchanged' (the optimizer's step leaves the state
    as it was), 'half_batch' (each micro-batch's objective over its
    first half only)."""
    if fault is None:
        return
    if fault == "unchanged":
        job.opt.adam.step = lambda *a, **k: None
    elif fault == "half_batch":
        loss_fn = job.process.loss_fn

        def half(x, key=0, t=None, eps=None):
            h = x.shape[0] // 2
            return loss_fn(x[:h], key, t=t[:h], eps=eps[:h])
        job.process.loss_fn = half
    else:
        raise ValueError(f"unknown fault {fault!r}")
