"""The bulk sampler's job: the ancestral chain of dDDPM from t = T - 1
down at the traffic's batch, for as long as the window lasts, then the
decode of the latent reached (`rescaled_upsample`, `fix_samples`).

The benchmark draws every input from the seed and hands it to the
program: the start latent and each step's noise (`noise=` of
`p_sample_chain`).  The window runs the chain in calls of
`segment_steps` steps, each closed by a synchronize; the checked steps
run as calls of one step, whose input and output are copied to the
host for the check, so that the card holds only the program's state.
sample_imgs_s charges the decode pro rata: a thousandth of a batch
costs one chain step and a thousandth of the decode.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

from benchmark.harness import common, flops as model_flops, seeds, weights
from benchmark.harness.trace import mark, traced
from benchmark.reference import compare
from benchmark.reference.diffusion import Reference
from benchmark.reference.precision import full_f32


def latent_shape(config: dict) -> tuple:
    size = config["image_size"] // 2 ** config["n_downsamples"]
    return (size, size, config["unet_in"])


class SampleJob:
    kind = "sample"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.batch = int(traffic["batch_size"])
        self.held: Dict[int, tuple] = {}
        self.calib_seed = seeds.mix(seed, seeds.CALIB)

    # --------------------------------------------------------------- set-up

    @torch.no_grad()
    def setup(self, fault: Optional[str] = None) -> None:
        """Builds the program, draws the inputs, warms up; `fault` (tests
        only) is planted first, see `plant`."""
        from dddpm_tpu_torch.models.factory import build_model
        from dddpm_tpu_torch.sample import fix_samples

        t0 = common.now()
        cfg = dict(self.config, batch_size=self.batch)
        self.net, self.process, _, _ = build_model(cfg, self.device)
        t1 = common.now()
        weights.load_into(self.net, weights.draw(self.config, self.seed,
                                                 self.device))
        common.sync(self.device)
        t2 = common.now()
        if self.config.get("conv_quant"):   # as generate_main calibrates
            from dddpm_tpu_torch.quantize import maybe_calibrate
            maybe_calibrate(cfg, self.net, self.process,
                            batch_size=cfg["quant_calib_batch"],
                            mode=cfg["quant_calib"], seed=self.calib_seed)
            common.sync(self.device)
        t3 = common.now()
        self.fix_samples = fix_samples
        plant(self, fault)
        self.shape = (self.batch, *latent_shape(self.config))
        self.z_start = torch.randn(
            self.shape, device=self.device,
            generator=seeds.generator(self.device, self.seed, seeds.START))
        self.ts = self.process.chain_ts()
        gen = torch.Generator().manual_seed(seeds.mix(self.seed, seeds.CHECKS))
        later = torch.randperm(int(self.traffic["min_steps"]) - 1,
                               generator=gen)[:int(self.traffic["checked_steps"]) - 1]
        self.checks = sorted({0} | {int(i) + 1 for i in later})
        # the host's copies of the checked steps' input and output, made
        # here: pinning memory in the window would stall it
        self.pinned = ([torch.empty(self.shape, pin_memory=True)
                        for _ in range(2 * len(self.checks))]
                       if self.device.type == "cuda" else [])
        # warm-up: a chain call and a decode at the window's shapes
        z = self.process.p_sample_chain(self.z_start, self.ts[:2],
                                        noise=self.noise)
        self.fix_samples(self.process.rescaled_upsample(z))
        del z
        common.sync(self.device)
        self.phases = {"model": t1 - t0, "weights": t2 - t1,
                       "calibration": t3 - t2,
                       "inputs and warm-up": common.now() - t3}

    def noise(self, t: int) -> torch.Tensor:
        return torch.randn(self.shape, device=self.device,
                           generator=seeds.generator(self.device, self.seed, t))

    # --------------------------------------------------------------- window

    def _calls(self, i: int, stop: int):
        """(start, steps) of the chain calls from step i until `stop`."""
        seg = int(self.traffic["segment_steps"])
        while i < stop:
            if i in self.checks:
                n = 1
            else:
                nxt = min([c for c in self.checks if c > i] + [stop])
                n = min(seg, nxt - i)
            yield i, n
            i += n

    def _call(self, img, i: int, n: int):
        # the copy is in stream order, before the step runs
        before = self._to_host(img) if i in self.checks else None
        out = self.process.p_sample_chain(img, self.ts[i:i + n],
                                          noise=self.noise)
        if before is not None:
            self.held[i] = (before, self._to_host(out))
        return out

    def _key(self, step: int) -> int:
        """The kind of a step's work: 1 where the check copies its input
        and output to the host, else 0."""
        return int(step in self.checks)

    def _to_host(self, x):
        if x.device.type != "cuda":
            return x.clone()
        buf = self.pinned.pop() if self.pinned else None
        if buf is None or buf.shape != x.shape or buf.dtype != x.dtype:
            buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return buf.copy_(x, non_blocking=True)

    @torch.no_grad()
    def window(self, seconds: float, trace: bool) -> Dict:
        """Runs the measured window; returns the end-to-end figures and,
        traced, the record the per-layer metrics read."""
        rec = common.Record(self.kind, self.config, self.traffic, self.batch)
        img, i, total = self.z_start, 0, len(self.ts)
        min_steps = int(self.traffic["min_steps"])
        common.sync(self.device)
        if trace:
            # a call a step between marks; the traced steps take in a
            # checked step (0) and a plain one, the two kinds of work
            n_traced = max(int(self.traffic["traced_steps"]),
                           next(s for s in range(total)
                                if s not in self.checks) + 1)
            before, out, calls = common.launches(), [], []
            with traced(out):
                for a, n in self._calls(0, n_traced):
                    img = self._call(img, a, n)
                    calls.append((self._key(a), n))
                    mark()
                common.sync(self.device)
            rec.traced, rec.traced_steps = out[0], n_traced
            rec.traced_launches = common.delta(common.launches(), before)
            busy: Dict[int, float] = {}
            steps: Dict[int, int] = {}
            for (key, n), b in zip(calls, rec.traced.step_busy()):
                busy[key] = busy.get(key, 0.0) + b
                steps[key] = steps.get(key, 0) + n
            rec.busy_by_key = {k: busy[k] / steps[k] for k in busy}
            with traced(out, host=True):   # one step, for the idle gaps
                for a, n in self._calls(n_traced, n_traced + 1):
                    img = self._call(img, a, n)
                common.sync(self.device)
            rec.host_traced = out[1]
            i = n_traced + 1
        t0 = common.now()
        for a, n in self._calls(i, total):
            img = self._call(img, a, n)
            i = a + n
            common.sync(self.device)
            if common.now() - t0 >= seconds and i >= min_steps:
                break
        rec.steps = i - (rec.traced_steps + 1 if trace else 0)
        rec.seconds = common.now() - t0
        rec.window_keys = [self._key(s) for s in range(i - rec.steps, i)]
        t1 = common.now()
        self.image = self.process.rescaled_upsample(img)
        self.fixed = self.fix_samples(self.image)
        common.sync(self.device)
        rec.decode_s = common.now() - t1
        self.final = img
        per_batch = len(self.ts) * rec.seconds / rec.steps + rec.decode_s
        if trace:
            f = model_flops.per_image(self.config)
            share = rec.steps / len(self.ts)
            rec.flops = self.batch * (rec.steps * f["unet_fwd"]
                                      + share * f["up_fwd"])
        return {"rate": self.batch / per_batch, "steps": i,
                "record": rec}

    def release(self) -> None:
        """Frees the program's state, keeping what the check judges."""
        self.net = self.process = None
        common.free(self.device)

    # ---------------------------------------------------------------- check

    def check(self, precs: Iterable[str] = ()) -> Dict[str, Dict[str, float]]:
        """The numbers compared, {'program': ...}, and for each of `precs`
        the same numbers of the reference at that precision put in the
        program's place (the control)."""
        rows = int(self.traffic["reference_rows"])
        w = weights.draw(self.config, self.seed, self.device)
        with full_f32():
            ref = Reference(self.config, w, self.device, rows=rows)
            lows = {p: Reference(self.config, w, self.device, prec=p, rows=rows)
                    for p in precs}
            if self.config.get("conv_quant"):
                self._calibrate(ref, lows.values())
            out = {k: {"step_gap": 0.0} for k in ["program", *precs]}
            s = ref.schedule
            for i, held in sorted(self.held.items()):
                x_in, x_out = (x.to(self.device) for x in held)
                t = self.ts[i]
                z = self.noise(t)
                want, eps, inside = ref.p_sample(x_in, t, z)
                weight = float(s.coef_x0[t] * s.sqrt_recipm1_ab[t])
                for k, got in [("program", x_out)] + [
                        (p, lows[p].p_sample(x_in, t, z)[0]) for p in precs]:
                    gap = compare.step_gap(got, want, eps, inside, weight)
                    out[k]["step_gap"] = max(out[k]["step_gap"], gap)
                del want, eps, inside, z, x_in, x_out
            fixed_ref = compare.fix(ref.decode(self.final))
            out["program"]["decode_gap"] = compare.decode_gap(self.fixed,
                                                              fixed_ref)
            for p in precs:
                low = compare.fix(lows[p].decode(self.final)).cpu().numpy()
                out[p]["decode_gap"] = compare.decode_gap(low, fixed_ref)
        return out

    def _calibrate(self, ref, lows) -> None:
        """The references work the int8 scales out again, from the
        calibration's own start and noise."""
        if self.config["quant_calib"] != "trajectory":
            raise ValueError("the reference calibrates the trajectory mode only")
        batch = int(self.config["quant_calib_batch"])
        shape = (batch, *latent_shape(self.config))

        def noise(t):
            return torch.randn(shape, device=self.device, generator=seeds.generator(
                self.device, self.calib_seed, t))
        snaps = ref.calibrate(self.calib_seed, noise, batch)
        for low in lows:
            low.calibrate(self.calib_seed, noise, batch, snapshots=snaps)


def plant(job: SampleJob, fault: Optional[str]) -> None:
    """Breaks the timed path underneath the job, for the test that the
    check catches it: 'unchanged' (a chain step returns its state),
    'half_batch' (the second half of the batch is left as it came in),
    'altered' (one image of each decode is changed where it is made)."""
    if fault is None:
        return
    process = job.process
    if fault in ("unchanged", "half_batch"):
        step = process.p_sample

        def p_sample(x_t, t, noise):
            out = step(x_t, t, noise)
            if fault == "unchanged":
                return x_t.clone()
            half = x_t.shape[0] // 2
            return torch.cat([out[:half], x_t[half:]])
        process.p_sample = p_sample
    elif fault == "altered":
        up = process.rescaled_upsample

        def rescaled_upsample(z):
            x = up(z).clone()
            x[0] = -x[0]
            return x
        process.rescaled_upsample = rescaled_upsample
    else:
        raise ValueError(f"unknown fault {fault!r}")
