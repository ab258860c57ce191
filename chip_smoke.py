"""Runs the PyTorch port on one CUDA card and checks it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. builds the kernels of dddpm_tpu_torch/csrc/ with nvcc for sm_90a, in
   parallel, and prints the ptxas report;
3. holds each kernel against its plain PyTorch version on the card at
   the x2 main path's shapes (B = 8), in bf16 and in f32 (TF32 off), and
   times both with CUDA events;
4. drives the x2 dDDPM sampling path through the port's entry points
   (build_model -> init_fn -> generate_samples, a chain cut to
   CHAIN_STEPS steps, then p_sample_chain over ts = [2, 1, 0]) with the
   launch counters zeroed just before and read just after, and checks
   the outputs, profiles three chain steps (device time by kernel
   category, idle share), and runs one short f32 chain on the card
   against the plain path on the CPU.

The last two lines are a JSON object with the kernels' numbers and
{"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

from dddpm_tpu_torch.models.factory import build_model
from dddpm_tpu_torch.ops import _build
from dddpm_tpu_torch.ops import attention_block as ab
from dddpm_tpu_torch.ops import convres as cr
from dddpm_tpu_torch.sample import generate_samples

# bench.py:_sample_config(batch_size=8): dDDPM x2 at CelebA-HQ 256^2
X2_CONFIG = {
    "model": "dddpm", "dataset": "celeba_hq", "image_size": 256,
    "batch_size": 8, "T": 1000, "loss_type": "simple",
    "beta_schedule": "linear", "loss_flat": "sum",
    "unet_chan": 128, "unet_dims": (1, 2, 2, 2), "unet_dropout": 0.1,
    "unet_in": 8, "n_downsamples": 1,
    "d_mode": "convolutional_res", "u_mode": "convolutional_res",
    "d_dropout": 0, "d_chans": 64, "d_n_blocks": 3, "u_n_blocks": 3,
    "ae_loss": True, "t_rec_max": 100, "force_latent": True,
    "compute_dtype": "bfloat16",
}
B = 8
CHAIN_STEPS = 50
# the five attention sites above 512 tokens, in UNet order: (N, C)
ATTN_SITES = [(16384, 128), (4096, 256), (1024, 256), (1024, 256), (4096, 128)]
# the three decoder ConvResBlocks (H, W, scale), plus the downsampler's
CONVRES_DECODE = [(128, 128, "up"), (256, 256, None), (256, 256, None)]
CONVRES_DOWN = (256, 256, "down")
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
KERNELS = ["attention_block", "convres_fwd"]
REPLACES = {
    "attn_ctx": "dddpm_tpu/ops/pallas/attention_block.py:148",
    "attn_out": "dddpm_tpu/ops/pallas/attention_block.py:210",
    "convres_fwd": "dddpm_tpu/ops/pallas/convres.py:250",
}
SOURCES = {"attn_ctx": "dddpm_tpu_torch/csrc/attention_block.cu",
           "attn_out": "dddpm_tpu_torch/csrc/attention_block.cu",
           "convres_fwd": "dddpm_tpu_torch/csrc/convres_fwd.cu"}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(cost: dict, dtype) -> tuple:
    t_bytes = cost["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = cost["flops"] / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_close(name, got, want, dtype):
    """bf16: 3% of the output's largest magnitude (each rounded stage may
    land one bf16 ulp, 0.4-0.8%, apart between kernel and plain
    version, and the error compounds over the stages); f32: 1e-3 of it
    (sums in another order, no TF32)."""
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    tol = (3e-2 if dtype == torch.bfloat16 else 1e-3) * scale
    ok = np.isfinite(err) and err <= tol
    log(f"  {name}: max_abs_err {err:.3e} (tol {tol:.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def attn_inputs(n, c, dtype, gen):
    dev = "cuda"
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    x = r(B, n, c).to(dtype)
    g = 1.0 + 0.1 * r(c)
    b = 0.1 * r(c)
    w_qkv = (r(c, 3 * ab.HIDDEN) / c ** 0.5).to(dtype)
    w_out = (r(ab.HIDDEN, c) / ab.HIDDEN ** 0.5).to(dtype)
    b_out = 0.1 * r(c)
    return x, g, b, w_qkv, w_out, b_out


def phase_attention(results):
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        log(f"attention block, {dtype}:")
        for n, c in sorted(set(ATTN_SITES), reverse=True):
            x, g, b, w_qkv, w_out, b_out = attn_inputs(n, c, dtype, gen)
            w_q, w_k, w_v = (w_qkv.reshape(c, 3, ab.HIDDEN)[:, i] for i in range(3))
            w_kv = torch.cat([w_k, w_v], dim=1).contiguous()
            ctx = ab.attention_ctx(x, g, b, w_kv)
            ctx_ref = ab.ctx_reference(x, g, b, w_kv)
            e_ctx = check_close(f"attn_ctx N={n} C={c}", ctx, ctx_ref, dtype)
            w_eff = ab.fold_w_eff(w_q, ctx_ref, w_out, dtype)
            y = ab.attention_out(x, g, b, w_eff, b_out)
            e_out = check_close(f"attn_out N={n} C={c}", y,
                                ab.out_reference(x, g, b, w_eff, b_out), dtype)
            with torch.no_grad():
                block = ab.attention_block(x, g, b, w_qkv, w_out, b_out)
            check_close(f"block N={n} C={c} vs reference_impl", block,
                        ab.reference_impl(x, g, b, w_qkv, w_out, b_out), dtype)
            costs = ab.cost(B, n, c, x.element_size())
            timings = {
                "attn_ctx": (lambda: ab.attention_ctx(x, g, b, w_kv),
                             lambda: ab.ctx_reference(x, g, b, w_kv), e_ctx),
                "attn_out": (lambda: ab.attention_out(x, g, b, w_eff, b_out),
                             lambda: ab.out_reference(x, g, b, w_eff, b_out),
                             e_out),
            }
            for name, (kern, plain, err) in timings.items():
                ms, plain_ms = cuda_ms(kern, 20), cuda_ms(plain, 20)
                bnd, by = bound_ms(costs[name], dtype)
                log(f"    {name} N={n} C={c} {dtype}: kernel {ms * 1e3:.1f} us, "
                    f"plain {plain_ms * 1e3:.1f} us, bound {bnd * 1e3:.1f} us "
                    f"({by})")
                if dtype == torch.bfloat16:
                    sites = ATTN_SITES.count((n, c))
                    acc = results.setdefault(name, dict(
                        ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0,
                        bytes=0, flops=0))
                    acc["ms"] += sites * ms
                    acc["plain_ms"] += sites * plain_ms
                    acc["bound_ms"] += sites * bnd
                    acc["bytes"] += sites * costs[name]["bytes"]
                    acc["flops"] += sites * costs[name]["flops"]
                    acc["max_abs_err"] = max(acc["max_abs_err"], err)


def convres_inputs(h, w, dtype, gen):
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    c, cm = 64, cr.MID_CHANNELS
    return (r(B, h, w, c).to(dtype),
            r(1, 1, c, cm) / c ** 0.5, 0.1 * r(cm) + 1.0,
            r(3, 3, cm, cm) / (9 * cm) ** 0.5, 0.1 * r(cm) + 1.0,
            r(3, 3, cm, cm) / (9 * cm) ** 0.5, 0.1 * r(cm),
            r(1, 1, cm, c) / cm ** 0.5, 0.1 * r(c))


def phase_convres(results):
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.bfloat16, torch.float32):
        log(f"ConvResBlock, {dtype}:")
        for h, w, scale in [CONVRES_DECODE[0], CONVRES_DECODE[1], CONVRES_DOWN]:
            args = convres_inputs(h, w, dtype, gen)
            with torch.no_grad():
                y = cr.fused_convres_block(*args, residual=True, scale=scale)
                want = cr.reference_impl(*args, residual=True, scale=scale)
                err = check_close(f"convres {h}x{w} scale={scale}", y, want, dtype)
                ms = cuda_ms(lambda: cr.fused_convres_block(
                    *args, residual=True, scale=scale), 5)
                plain_ms = cuda_ms(lambda: cr.reference_impl(
                    *args, residual=True, scale=scale), 5)
            cost = cr.cost(B, h, w, 64, args[0].element_size(), scale)
            bnd, by = bound_ms(cost, dtype)
            log(f"    convres {h}x{w} scale={scale} {dtype}: kernel "
                f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, bound "
                f"{bnd * 1e3:.1f} us ({by})")
            if dtype == torch.bfloat16 and scale != "down":
                sites = sum(1 for s in CONVRES_DECODE if s == (h, w, scale))
                acc = results.setdefault("convres_fwd", dict(
                    ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0,
                    bytes=0, flops=0))
                acc["ms"] += sites * ms
                acc["plain_ms"] += sites * plain_ms
                acc["bound_ms"] += sites * bnd
                acc["bytes"] += sites * cost["bytes"]
                acc["flops"] += sites * cost["flops"]
                acc["max_abs_err"] = max(acc["max_abs_err"], err)


def reset_counts():
    for d in (ab.LAUNCHES, cr.LAUNCHES):
        for k in d:
            d[k] = 0


def counts() -> dict:
    return {**ab.LAUNCHES, **cr.LAUNCHES}


def phase_main_path(results):
    net, process, init_fn, config = build_model(X2_CONFIG)
    init_fn(0)
    early_stop = config["T"] - CHAIN_STEPS
    log(f"main path: x2 dDDPM, B={B}, chain {CHAIN_STEPS} steps "
        f"(t {config['T'] - 1}..{early_stop}), bf16")
    process.sample(B, seed=123, early_stop=config["T"] - 2)   # warm-up
    torch.cuda.synchronize()

    reset_counts()
    samples, latents, timing = generate_samples(
        process, seed=0, fid_samples=B, batch_size=B, early_stop=early_stop,
        progress=False)
    launched = counts()
    log(f"  launches: {launched}")
    assert samples.shape == (1, B, 256, 256, 3), samples.shape
    assert latents.shape == (1, B, 128, 128, 8), latents.shape
    assert np.isfinite(samples).all() and np.isfinite(latents).all()
    assert samples.min() >= 0.0 and samples.max() <= 255.0
    assert launched["attn_ctx"] == 5 * CHAIN_STEPS, launched
    assert launched["attn_out"] == 5 * CHAIN_STEPS, launched
    assert launched["convres_fwd"] == 3, launched
    for name in results:
        results[name]["launches"] = launched[name]
    ms_step = timing["total_s"] * 1e3 / CHAIN_STEPS
    log(f"  {timing['total_s']:.3f} s for {CHAIN_STEPS} steps + decode: "
        f"{ms_step:.2f} ms/step (decode included), "
        f"{timing['imgs_per_sec']:.3f} imgs/s at this chain length "
        f"[{card_line()}]")

    # the last steps of a chain, t = 2, 1, 0; at t == 0 the noise is masked
    z = process.init_latent(B, seed=7)
    reset_counts()
    z_out = process.p_sample_chain(z, [2, 1, 0], seed=7)
    launched = counts()
    assert launched["attn_ctx"] == 15 and launched["attn_out"] == 15, launched
    assert torch.isfinite(z_out).all() and z_out.shape == (B, 128, 128, 8)
    z_a = process.p_sample_chain(z, [0], noise=torch.zeros((1, *z.shape)))
    z_b = process.p_sample_chain(z, [0], noise=torch.ones((1, *z.shape)))
    assert torch.equal(z_a, z_b), "noise not masked at t == 0"
    log("  p_sample_chain ts=[2, 1, 0]: finite, 15 launches per pass, "
        "t == 0 noise masked")
    return net, process


def _category(name: str) -> str:
    n = name.lower()
    for key, cat in (("ctx_partial", "K1a attn_ctx"), ("ctx_reduce", "K1a attn_ctx"),
                     ("out_kernel", "K1b attn_out"), ("convres", "K2 convres"),
                     ("group_norm", "group norm"), ("gemm", "gemm/conv"),
                     ("conv", "gemm/conv"), ("xmma", "gemm/conv"),
                     ("cutlass", "gemm/conv"), ("nchw", "layout copy"),
                     ("nhwc", "layout copy"), ("copy", "layout copy"),
                     ("reduce", "reductions"), ("elementwise", "elementwise"),
                     ("vectorized", "elementwise"), ("randn", "rng"),
                     ("philox", "rng")):
        if key in n:
            return cat
    return "other"


def phase_profile(process, steps: int = 3):
    """Where a chain step's device time goes: torch.profiler over
    `steps` steps at B; kernel time by category, device-busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    z = process.init_latent(B, seed=11)
    ts = list(range(900, 900 - steps, -1))
    process.p_sample_chain(z, ts, seed=11)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        process.p_sample_chain(z, ts, seed=11)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log("profile: the profiler saw no device time (not measured)")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    by_cat: dict = {}
    for e in kernels:
        cat = _category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + e.time_range.elapsed_us()
    total = sum(by_cat.values())
    log(f"profile, {steps} chain steps at B={B} (bf16): wall "
        f"{wall_ms / steps:.2f} ms/step, device busy {busy / 1e3 / steps:.2f} "
        f"ms/step, idle share of the device window "
        f"{1 - busy / window:.3f}, {len(kernels) // steps} kernels/step")
    for cat, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        log(f"  {cat:14s} {us / 1e3 / steps:8.3f} ms/step  {us / total:6.1%}")
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    log("  top kernels:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"    {us / 1e3 / steps:7.3f} ms/step  {name[:100]}")


def phase_against_cpu(net_bf16):
    """Two chain steps and the decode at B = 1 in f32 on the card (the
    kernels) against the same weights on the CPU (the plain path)."""
    cfg = dict(X2_CONFIG, compute_dtype="float32")
    net_gpu, proc_gpu, _, _ = build_model(cfg)
    net_cpu, proc_cpu, _, _ = build_model(cfg, device="cpu")
    state = {k: v.float().cpu() for k, v in net_bf16.state_dict().items()}
    net_gpu.load_state_dict(state)
    net_cpu.load_state_dict(state)
    gen = torch.Generator().manual_seed(3)
    z = torch.randn((1, 128, 128, 8), generator=gen)
    noise = torch.randn((2, 1, 128, 128, 8), generator=gen)
    ts = [500, 499]
    reset_counts()
    z_gpu = proc_gpu.p_sample_chain(z.cuda(), ts, noise=noise.cuda())
    with torch.no_grad():
        x_gpu = proc_gpu.rescaled_upsample(z_gpu)
    assert counts()["attn_ctx"] == 10 and counts()["convres_fwd"] == 3
    z_cpu = proc_cpu.p_sample_chain(z, ts, noise=noise)
    with torch.no_grad():
        x_cpu = proc_cpu.rescaled_upsample(z_cpu)
    ez = float((z_gpu.cpu() - z_cpu).abs().max())
    ex = float((x_gpu.cpu() - x_cpu).abs().max())
    log(f"f32 card vs CPU plain path: latent max_abs_err {ez:.3e}, "
        f"image max_abs_err {ex:.3e} (tol 1e-3: f32 sums in other orders)")
    assert ez < 1e-3 and ex < 1e-3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    _build.build_all(KERNELS)
    log(f"built {KERNELS} in {time.time() - t0:.1f} s")
    for name, text in _build.BUILD_LOGS.items():
        log(f"--- ptxas {name} ---\n{text.strip()}")

    results: dict = {}
    phase_attention(results)
    phase_convres(results)
    net, process = phase_main_path(results)
    phase_profile(process)
    phase_against_cpu(net)

    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": r["launches"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": ("bytes" if r["bytes"] / HBM_BYTES_PER_S
                     >= r["flops"] / PEAK_FLOPS[torch.bfloat16]
                     else "operations"),
        "library_ms": None,
    } for name, r in results.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
