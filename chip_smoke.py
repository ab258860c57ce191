"""Runs the PyTorch port on one CUDA card and checks it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. builds the kernels of dddpm_tpu_torch/csrc/ with nvcc for sm_90a, in
   parallel, and prints the ptxas report;
3. holds each kernel against its plain PyTorch version on the card at
   the main paths' shapes, in bf16 and in f32 (TF32 off), and times both
   with CUDA events: the attention block and the ConvResBlock forward at
   the x2 sampling shapes (B = 8; the ptxas lines of K1a's, K1b's and
   K1c's bf16 kernels and K2's first, no spill allowed; K1a and K1b
   also replayed from a CUDA graph; then both passes and K1c at C = 40,
   512 and 1024 against their plain versions), the attention block and the ConvResBlock backward (K3's
   ptxas line first, no spill allowed) and forward at the x3 training
   shapes; K2's and K3's bf16 times logged per shape, eager (the kernels
   line's `ms`) and replayed from a CUDA graph (`graph_ms`: its kernels
   without the host's gaps between launches); K3 beside cuDNN doing the
   block's eleven convs at the same shapes (`library_ms`, a yardstick
   the port never calls);
4. drives the x2 dDDPM sampling path through the port's entry points
   (build_model -> init_fn -> generate_samples, a chain cut to
   CHAIN_STEPS steps, then p_sample_chain over ts = [2, 1, 0]) with the
   launch counters zeroed just before and read just after, and checks
   the outputs, profiles three chain steps at B and two at the bulk
   sampler's B = 192 (device time by kernel category, idle share, K1's
   share), and runs one short f32 chain on the card against the plain
   path on the CPU;
5. drives the x3 dDDPM training path (setup_trainer -> train(), the
   config of bench.py:run_train, B = 32, accumulation x2, bf16, on
   synthetic 256^2 data) for TRAIN_STEPS steps with the counters zeroed
   just before and read just after, checks them against the recon rows
   each micro-batch draws, checks the loss, the update and a checkpoint
   round trip, times and profiles further steps, and runs one f32 train
   step (B = 2) on the card against the plain path on the CPU;
6. the x2 UNet's ResnetBlock seam (K5): its ptxas line (no spill
   allowed); the seam with conv2 through the fused conv (GroupNorm
   folded into its prologue) against the unfused seam, and the kernel
   against its plain version with the seam's gn-fold + post_bias
   prologue and with the identity prologue, at the three seam shapes
   with the x2 model's own ResnetBlock weights, bf16 and f32; in bf16
   K5 timed with the seam's prologue (the kernels line's `ms`, eager)
   and the identity one (`identity_ms`), and from CUDA graphs
   (`graph_ms`), against F.conv2d eager and from CUDA graphs (TFLOP/s
   and share of the bound per seam); then the seams run once more with
   the counters zeroed;
7. the x2 3x3 convs through the Winograd kernel (K6), the same shapes
   and weights, with and without mish, against its plain version (its
   bf16 roundings of V and U), timed against F.conv2d (TFLOP/s, share of
   the bound, ratio to cuDNN; eager like every kernel here, and replayed
   from CUDA graphs beside it), with its ptxas line (no spill allowed);
   counted likewise, its weight-transform launches too;
8. linear attention (K4) at the x2 UNet's five attention sites above
   512 tokens (B = 8), q, k, v from LN(x) and the site's own qkv
   weights, against its plain version (its ptxas lines first, no spill
   allowed), in bf16 also timed from CUDA graphs; counted likewise, then
   ten passes over the sites profiled (its kernels' device time);
9. the one-pass attention block (K1c): per launch at the five sites
   against its plain version and against the two-pass route (passes A
   and B and the fold), in bf16 its bits repeated across two launches
   and its time printed beside the two-pass route's and their
   difference, eager and from CUDA graphs, then the x2 chain
   (generate_samples, cut to CHAIN_1P_STEPS steps) with FORCE_ONE_PASS
   set and the counters zeroed, checked against the two-pass chain from
   the same seed;
10. the probes P1-P4 (dddpm_tpu_torch/probes/): the ptxas lines of P1's
   two passes, P4's conv, P3's seven variants and P2's two copies (no
   spill allowed), then, with the counters zeroed just before and read
   just after, each probe's main() at the TPU probe's default size holds
   every variant of
   its kernels against its plain version on the card, then times it (P1
   beside the shipped K1a and K1b alone, P3 beside the shipped K2 alone
   with each variant's ratio to it, the entries' `shipped_ms`; P4
   beside cuDNN on NCHW, the entry's `library_ms`, and on channels_last,
   `library_cl_ms`); then K3's ablation (probes/convres_bwd_ablation.py:
   K3 with parts compiled out, timed at the x3 training shapes) and
   K1a/K1b's (probes/attention_ablation.py: the same at the x2 sites,
   then the tensor-core and the FMA kernels in bf16 at 512 channels,
   each checked against the plain versions, then timed);
11. the evaluation path, through the port's entry points, each with the
   counters zeroed just before and read just after (run after phase 5,
   before phase 10): resume_main takes phase 5's x3 checkpoint 2 steps
   further; generate_main samples 192 images by DDIM-50 at B = 192 from
   a saved x2 checkpoint (full width, random init, synthetic 256^2);
   ref_batch_main writes 192 reference images; evaluate_main runs one
   B = 8 batch of the full 1000-t test-set VLB and FID / sFID / IS /
   precision / recall through the random-init Inception; compare_main
   holds the reference batch against itself; then the Inception heads
   on the card against the CPU and the pairwise-distance tile against
   float64 numpy.  It prints one {"eval_path": ...} line.
12. the int8 serving mode (after phase 11, before phase 10): Q1's ptxas
   lines (every instantiation, no spill allowed); Q1 (csrc/int8_conv.cu)
   against its plain version, bit for bit, at the x2 UNet's five
   quantized shape classes at B = 8 and B = 192, with and without a skip
   operand, on NCHW and on channels_last operands (at B = 8 also x and
   the skip in different layouts), each timed beside its bound and
   F.conv2d bf16 on the same layout (library_ms: the call the site makes
   without int8; the kernels line takes the NCHW times, the layout the
   path hands 24 of 30 launches); one int8 UNet eval with Q1's C entry
   wrapped, which must get the very tensor each quantized conv was given
   (no copy before Q1); two profiled chain steps at B = 192, int8 /
   bf16 / int8 on the same weights, the layout copies listed;
   generate_main --quant-conv int8 on phase 11's x2 checkpoint
   (trajectory calibration at batch 4, the chain cut to CHAIN_STEPS
   steps at B = 8, the decode) with the counters zeroed just before and
   read just after: Q1 30 launches (32 operands) per UNet eval, K1a/K1b
   5 + 5 per eval, K2 3; one f32 quantized UNet eval on the card against
   the CPU's plain path on the same calibrated buffers; the subpixel
   transposed conv (ops/convt.py) against F.conv_transpose2d at the x2
   Upsamples' shapes at B = 8 and 192, both timed.  It prints one
   {"int8_path": ...} line.
13. the widths past the tuned kernels' (after phase 12, before phase
   10): K2's and K3's width-general route (csrc/convres_general.cu)
   against their plain versions at (cm, cio) = (64, 128), (96, 192),
   (128, 256), (32, 96) and (96, 160), B = 2, 128^2 (K2 with no
   scaling, 'up' and 'down'), bf16 and f32, each timed eager beside its
   bound and cuDNN doing the block's convs alone (bf16, channels_last; a
   yardstick, never called by the port), and K3's bits equal across two
   launches at cm 128 (the route's ptxas lines first: bf16 on the tensor
   cores, f32 on FMA, no spill allowed); the x2 sampling path at
   d_chans 128 (generate_samples, 2 chain steps and the decode, B = 8)
   with the counters zeroed: K2 general at each of the upsampler's three
   fused blocks; one x3 train step at d_chans 128 (B = 8 x accumulation
   2, 4 recon rows per micro-batch) with remat off and on, counted
   likewise (K2 general 26, K3 general 18), the losses equal and both
   peaks of device memory printed; Q1 against its plain version, bit for
   bit, at C = 144 and 160 on both layouts with and without the skip
   operand, and an int8 unet_chan 160 model's chain steps with Q1 at
   every quantized conv; K4, K5 and K6 at one ragged width each against
   their plain versions.  It prints one {"widths_path": ...} line.
14. multi-GPU (after phase 13, before phase 10): `python -m
   torch.distributed.run --standalone --nproc-per-node <cards> -m
   dddpm_tpu_torch.parallel.dryrun --full` as a subprocess, one NCCL
   rank per card (world size 1 on one card), at full width: the x3
   train step of phase 5 through setup_trainer and train_step on the
   mesh, 3 steps
   replicated and 3 FSDP-sharded with the counters zeroed before and
   read after each (K1a/K1b, K2 and K3 at the counts the recon rows
   predict), the replicated step's params and EMA held against the same
   steps run without the mesh in the same process (bit for bit at world
   1, cuDNN's deterministic algorithms in both), the FSDP step against
   the replicated one; the ms a step of the three step functions over
   the same 8 steps in turns (plain, replicated, FSDP, and back)
   and of the two trainers, the kernels and kernel time a step of each
   step function (torch.profiler), each rank's peak memory; the FSDP
   checkpoint round trip, bit for bit; the sharded x2
   bulk sampler (B = 192 over the ranks, the chain cut to 20 steps, the
   decode, fix_samples) against generate_samples without the mesh, bit
   for bit at world 1, its imgs/s; the sharded Inception pass (192 + 192
   images) against one process's.  A non-zero exit fails the script; it
   prints the subprocess's {"multigpu_path": ...} line.

The last three lines are a JSON object with the kernels' numbers (one
entry per kernel and path, its launches counted on that path's own run),
the card's name and power limit, and {"ok": true, "device": {...}}.
"""
import contextlib
import functools
import json
import os
import signal
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from dddpm_tpu_torch import (
    compare_main,
    evaluate_main,
    generate_main,
    ref_batch_main,
    resume_main,
)
from dddpm_tpu_torch.evaluation.inception import FeatureExtractor
from dddpm_tpu_torch.evaluation import prec_recall
from dddpm_tpu_torch.evaluation.prec_recall import pairwise_sq_dists
from dddpm_tpu_torch.models.blocks import Conv2d
from dddpm_tpu_torch.models.ddpm import draw_t, fold_seed
from dddpm_tpu_torch.models.factory import build_model
from dddpm_tpu_torch.models.resample import ConvResBlock
from dddpm_tpu_torch.ops import _build
from dddpm_tpu_torch.ops import attention_block as ab
from dddpm_tpu_torch.ops import conv3x3 as c3
from dddpm_tpu_torch.ops import convres as cr
from dddpm_tpu_torch.ops import linear_attention as la
from dddpm_tpu_torch.ops import quant as qt
from dddpm_tpu_torch.ops import winograd as wg
from dddpm_tpu_torch.ops.convt import conv_transpose_2x_subpixel
from dddpm_tpu_torch.ops.math import mish
from dddpm_tpu_torch.probes import attention_ablation as k1_ablation
from dddpm_tpu_torch.probes import attention_ceiling as probe_p1
from dddpm_tpu_torch.probes import attention_writeback as probe_p2
from dddpm_tpu_torch.probes import cmajor_conv as probe_p4
from dddpm_tpu_torch.probes import convres_bwd_ablation as k3_ablation
from dddpm_tpu_torch.probes import convres_variants as probe_p3
from dddpm_tpu_torch.probes._util import (
    HBM_BYTES_PER_S,
    PEAK_FLOPS,
    bound_ms,
    card_line,
    cuda_ms,
)
from dddpm_tpu_torch.quantize import calibrate_conv_quant
from dddpm_tpu_torch.sample import generate_samples
from dddpm_tpu_torch.train import checkpoint
from dddpm_tpu_torch.train.state import (
    create_optimizer,
    create_train_state,
    make_train_step,
)
from dddpm_tpu_torch.train.trainer import setup_trainer

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
KERNELS = ["attention_block", "convres_fwd", "convres_bwd", "convres_general",
           "conv3x3", "winograd", "linear_attention", "int8_conv",
           "probe_attention", "probe_copy", "probe_convres", "probe_cmajor_conv"]
REPLACES = {
    "attn_ctx": "dddpm_tpu/ops/pallas/attention_block.py:148",
    "attn_out": "dddpm_tpu/ops/pallas/attention_block.py:210",
    "attn_1pass": "dddpm_tpu/ops/pallas/attention_block.py:227",
    "convres_fwd": "dddpm_tpu/ops/pallas/convres.py:250",
    "convres_bwd": "dddpm_tpu/ops/pallas/convres.py:409",
    "convres_fwd_general": "dddpm_tpu/ops/pallas/convres.py:250",
    "convres_bwd_general": "dddpm_tpu/ops/pallas/convres.py:409",
    "conv3x3": "dddpm_tpu/ops/pallas/conv3x3.py:54",
    "winograd": "dddpm_tpu/ops/pallas/winograd.py:49",
    "lin_ctx": "dddpm_tpu/ops/pallas/linear_attention.py:51",
    "lin_out": "dddpm_tpu/ops/pallas/linear_attention.py:86",
    # not a Pallas kernel: the s8 x s8 -> s32 conv XLA computes there
    "int8_conv": "dddpm_tpu/ops/quant.py:93",
    "probe_attn_ctx": "scripts/probe_attention_ceiling.py:52",
    "probe_attn_out": "scripts/probe_attention_ceiling.py:131",
    "probe_copy": "scripts/probe_attention_writeback.py:38",
    "probe_copy_async": "scripts/probe_attention_writeback.py:72",
    "probe_convres": "scripts/probe_convres_variants.py:94",
    "probe_cmajor_conv": "scripts/probe_cmajor_conv.py:29",
}
SOURCES = {"attn_ctx": "dddpm_tpu_torch/csrc/attention_block.cu",
           "attn_out": "dddpm_tpu_torch/csrc/attention_block.cu",
           "attn_1pass": "dddpm_tpu_torch/csrc/attention_block.cu",
           "convres_fwd": "dddpm_tpu_torch/csrc/convres_fwd.cu",
           "convres_bwd": "dddpm_tpu_torch/csrc/convres_bwd.cu",
           "convres_fwd_general": "dddpm_tpu_torch/csrc/convres_general.cu",
           "convres_bwd_general": "dddpm_tpu_torch/csrc/convres_general.cu",
           "conv3x3": "dddpm_tpu_torch/csrc/conv3x3.cu",
           "winograd": "dddpm_tpu_torch/csrc/winograd.cu",
           "lin_ctx": "dddpm_tpu_torch/csrc/linear_attention.cu",
           "lin_out": "dddpm_tpu_torch/csrc/linear_attention.cu",
           "int8_conv": "dddpm_tpu_torch/csrc/int8_conv.cu",
           "probe_attn_ctx": "dddpm_tpu_torch/csrc/probe_attention.cu",
           "probe_attn_out": "dddpm_tpu_torch/csrc/probe_attention.cu",
           "probe_copy": "dddpm_tpu_torch/csrc/probe_copy.cu",
           "probe_copy_async": "dddpm_tpu_torch/csrc/probe_copy.cu",
           "probe_convres": "dddpm_tpu_torch/csrc/probe_convres.cu",
           "probe_cmajor_conv": "dddpm_tpu_torch/csrc/probe_cmajor_conv.cu"}
# the x2 UNet's attention modules at the ATTN_SITES, in the same order
ATTN_SITE_MODULES = [0, 1, 2, 6, 7]
# the x2 UNet's ResnetBlock seams (H = W, C, index of the ResnetBlock):
# the second block of the 128^2, 64^2 and 32^2 levels (C -> C)
SEAMS = [(128, 128, 1), (64, 256, 3), (32, 256, 4)]
CHAIN_1P_STEPS = 5

# bench.py:run_train: _sample_config(32) with n_downsamples 3, lr 2e-4:
# dDDPM x3 at CelebA-HQ 256^2 widths, on synthetic 256^2 images
X3_CONFIG = dict(X2_CONFIG, dataset="synthetic", batch_size=32,
                 n_downsamples=3, lr=2e-4, grad_accum=2, ema_decay=0.995,
                 prefetch=2, val_split=0, rnd_flip=False, recon_compact=True)
B_TRAIN = 32
TRAIN_STEPS = 3
B_REC = 3            # recon rows of a micro-batch: 32 * t_rec_max / T = 3.2
ATTN_TRAIN = (1024, 128)   # the one site above 512 tokens at a 32^2 latent
# the ConvResBlocks that run fused in training, x's (H, W, scale), with
# their launches per micro-batch that has recon rows: the downsampler's
# 256^2 'down', 128^2 x2, 128^2 'down'; the upsampler's 128^2 x2, 128^2
# 'up', 256^2 x2
TRAIN_BLOCKS = [((256, 256, "down"), 1), ((128, 128, None), 4),
                ((128, 128, "down"), 1), ((128, 128, "up"), 1),
                ((256, 256, None), 2)]
# per micro-batch: K2 runs these 9 at the recon rows under autograd and
# the downsampler's 4 at the full batch without; K3 runs the 9
FWD_PER_MB, BWD_PER_MB, FWD_NO_ROWS = 13, 9, 4
# what the times of a kernels-line entry are per, by (kernel, path);
# every entry has one (a missing one raises)
_SEAMS_AT = ", ".join(f"{hw}^2 c{c}" for hw, c, _ in SEAMS)
_PER_TRAIN = (f"x3 train step, B={B_TRAIN} x accumulation 2, {B_REC} recon "
              f"rows per micro-batch")
_PER_PROBE = "one launch at the TPU probe's default size, "
PER = {("attn_ctx", "x2_sample"): f"x2 chain step at B={B}",
       ("attn_out", "x2_sample"): f"x2 chain step at B={B}",
       ("convres_fwd", "x2_sample"): f"x2 decode at B={B}",
       ("attn_1pass", "x2_sample_1pass"):
           f"x2 chain step at B={B} with DDDPM_ATTN_ONE_PASS=1 (five sites); "
           f"two_pass_ms, two_pass_graph_ms: the two-pass route (A + fold + B) "
           f"at the same sites, eager and from CUDA graphs",
       ("conv3x3", "x2_seam"):
           f"x2 ResnetBlock seams at B={B}, one each at {_SEAMS_AT}",
       ("winograd", "x2_conv3x3"):
           f"x2 3x3 convs at B={B}, one each at {_SEAMS_AT}, no mish; each "
           f"with its weight-transform launch (winograd_weights)",
       ("lin_ctx", "x2_attn_sites"):
           f"x2 attention sites at B={B}, the five above 512 tokens",
       ("lin_out", "x2_attn_sites"):
           f"x2 attention sites at B={B}, the five above 512 tokens",
       **{(name, "x3_train"): _PER_TRAIN
          for name in ("attn_ctx", "attn_out", "convres_fwd", "convres_bwd")},
       ("probe_attn_ctx", "probes"):
           _PER_PROBE + "B=96, 128^2 tokens, C=128, bf16: pass A full, G=1; "
           "shipped_ms the shipped K1a alone at the same shape",
       ("probe_attn_out", "probes"):
           _PER_PROBE + "B=96, 128^2 tokens, C=128, bf16: pass B full, G=1; "
           "shipped_ms the shipped K1b alone at the same shape",
       ("probe_copy", "probes"):
           _PER_PROBE + "B=96, 128^2 tokens, C=128, bf16: base-8192",
       ("probe_copy_async", "probes"):
           _PER_PROBE + "B=96, 128^2 tokens, C=128, bf16: manual-8192",
       ("probe_convres", "probes"):
           _PER_PROBE + "B=32, 256^2, cio 64, cm 32, bf16: base; "
           "shipped_ms the shipped K2 alone at the same shape",
       ("probe_cmajor_conv", "probes"):
           _PER_PROBE + "B=32, C=32, 256^2, bf16; library_ms cuDNN on NCHW, "
           "library_cl_ms on channels_last"}
ROOT = os.path.dirname(os.path.abspath(__file__))
WORKDIR = os.path.join(ROOT, "results", "chip_smoke")   # git-ignored


def log(*a):
    print(*a, flush=True)


def accumulate(results, name, path, n, ms, plain_ms, bnd, cost, err,
               library_ms=None, **extra_ms):
    """Adds n launches' kernel, plain, bound (and library) times and cost
    to the kernels-line entry of (name, path); `extra_ms` are more times
    (keys of the entry too)."""
    acc = results.setdefault((name, path), dict(
        ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0, bytes=0,
        flops=0, launches=0, library_ms=None))
    if library_ms is not None:
        acc["library_ms"] = (acc["library_ms"] or 0.0) + n * library_ms
    acc["ms"] += n * ms
    acc["plain_ms"] += n * plain_ms
    acc["bound_ms"] += n * bnd
    acc["bytes"] += n * cost["bytes"]
    acc["flops"] += n * cost["flops"]
    acc["max_abs_err"] = max(acc["max_abs_err"], err)
    for k, v in extra_ms.items():
        acc[k] = acc.get(k, 0.0) + n * v


def tolerance(want, dtype) -> float:
    """bf16: 3% of the output's largest magnitude (each rounded stage may
    land one bf16 ulp, 0.4-0.8%, apart between kernel and plain
    version, and the error compounds over the stages); f32: 1e-3 of it
    (sums in another order, no TF32)."""
    scale = max(1.0, float(want.float().abs().max()))
    return (3e-2 if dtype == torch.bfloat16 else 1e-3) * scale


def check_close(name, got, want, dtype, quiet=False):
    """Raises unless got is within tolerance(want, dtype) of want."""
    err = float((got.float() - want.float()).abs().max())
    tol = tolerance(want, dtype)
    ok = np.isfinite(err) and err <= tol
    if not (quiet and ok):
        log(f"  {name}: max_abs_err {err:.3e} (tol {tol:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def attn_inputs(n, c, dtype, gen, bsz=B):
    dev = "cuda"
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    x = r(bsz, n, c).to(dtype)
    g = 1.0 + 0.1 * r(c)
    b = 0.1 * r(c)
    w_qkv = (r(c, 3 * ab.HIDDEN) / c ** 0.5).to(dtype)
    w_out = (r(ab.HIDDEN, c) / ab.HIDDEN ** 0.5).to(dtype)
    b_out = 0.1 * r(c)
    return x, g, b, w_qkv, w_out, b_out


def phase_attention(results):
    """K1 at the x2 sampling sites (B = 8; per chain step: five sites) and
    at the x3 training site (B = 32, N = 1024, C = 128; per train step:
    one launch per micro-batch).  The ptxas lines of the bf16 kernels
    (mma.sync) first, no spill allowed; in bf16 each pass also replayed
    from a CUDA graph (`graph_ms`)."""
    _build.build_all(["attention_block"])
    ptxas_check("attention_block", "ctx_mma_kernel")   # no kernel of it spills
    report = _build.ptxas_report("attention_block")
    for kernel in ("out_mma_kernel", "block_1p_mma_kernel"):
        assert any(kernel in k["kernel"] for k in report), kernel
    gen = torch.Generator(device="cuda").manual_seed(0)
    sites = [(n, c, B, "x2_sample", ATTN_SITES.count((n, c)))
             for n, c in sorted(set(ATTN_SITES), reverse=True)]
    sites.append((ATTN_TRAIN[0], ATTN_TRAIN[1], B_TRAIN, "x3_train", 2))
    for dtype in (torch.bfloat16, torch.float32):
        log(f"attention block, {dtype}:")
        for n, c, bsz, path, per_step in sites:
            x, g, b, w_qkv, w_out, b_out = attn_inputs(n, c, dtype, gen, bsz)
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
            costs = ab.cost(bsz, n, c, x.element_size())
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
                gms = graph_ms(kern, 20) if dtype == torch.bfloat16 else None
                graph = "" if gms is None else f" ({gms * 1e3:.1f} from a CUDA graph)"
                log(f"    {name} B={bsz} N={n} C={c} {dtype}: kernel "
                    f"{ms * 1e3:.1f} us{graph}, plain {plain_ms * 1e3:.1f} us, "
                    f"bound {bnd * 1e3:.1f} us ({by})")
                if dtype == torch.bfloat16:
                    accumulate(results, name, path, per_step, ms, plain_ms,
                               bnd, costs[name], err, graph_ms=gms)
    for path, what in (("x2_sample", f"x2 chain step at B={B}, five sites"),
                       ("x3_train", f"x3 train step, B={B_TRAIN} x 2")):
        for name in ("attn_ctx", "attn_out"):
            r = results[(name, path)]
            log(f"  {name}, {what}, bf16: kernel {r['ms']:.4f} ms eager, "
                f"{r['graph_ms']:.4f} from CUDA graphs, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"[{card_line()}]")


# widths beside the x2 sites': no 16-byte rows (20 is in the card tests),
# K and N padded (40), weights streamed in K-slabs and pass B's output
# in column slabs (512, 1024)
ATTN_WIDTHS = (40, 512, 1024)


def phase_attention_widths():
    """Both passes and K1c against their plain versions at ATTN_WIDTHS
    (B = 2, N = 1000), bf16 and f32; pass B also in place."""
    gen = torch.Generator(device="cuda").manual_seed(25)
    for dtype in (torch.bfloat16, torch.float32):
        for c in ATTN_WIDTHS:
            x, g, b, w_qkv, w_out, b_out = attn_inputs(1000, c, dtype, gen, 2)
            w_q, w_k, w_v = (w_qkv.reshape(c, 3, ab.HIDDEN)[:, i].contiguous()
                             for i in range(3))
            w_kv = torch.cat([w_k, w_v], dim=1).contiguous()
            ctx_ref = ab.ctx_reference(x, g, b, w_kv)
            check_close(f"width {c} {dtype} attn_ctx", ab.attention_ctx(x, g, b, w_kv),
                        ctx_ref, dtype)
            w_eff = ab.fold_w_eff(w_q, ctx_ref, w_out, dtype)
            want = ab.out_reference(x, g, b, w_eff, b_out)
            check_close(f"width {c} {dtype} attn_out",
                        ab.attention_out(x, g, b, w_eff, b_out), want, dtype)
            y = x.clone()
            check_close(f"width {c} {dtype} attn_out in place",
                        ab.attention_out(y, g, b, w_eff, b_out, out=y), want, dtype)
            check_close(f"width {c} {dtype} attn_1pass",
                        ab.attention_1pass(x, g, b, w_kv, w_q, w_out, b_out),
                        ab.one_pass_reference(x, g, b, w_qkv, w_out, b_out), dtype)


def convres_inputs(h, w, dtype, gen, bsz=B, c=64, cm=cr.MID_CHANNELS):
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    return (r(bsz, h, w, c).to(dtype),
            r(1, 1, c, cm) / c ** 0.5, 0.1 * r(cm) + 1.0,
            r(3, 3, cm, cm) / (9 * cm) ** 0.5, 0.1 * r(cm) + 1.0,
            r(3, 3, cm, cm) / (9 * cm) ** 0.5, 0.1 * r(cm),
            r(1, 1, cm, c) / cm ** 0.5, 0.1 * r(c))


def phase_convres(results):
    """K2 against reference_impl at the x2 decode shapes and 256^2
    'down' (B = 8), bf16 and f32, timed against it; its ptxas line (no
    spill allowed)."""
    ptxas_check("convres_fwd", "convres_fwd_kernel")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.bfloat16, torch.float32):
        log(f"ConvResBlock, {dtype}:")
        for h, w, scale in [CONVRES_DECODE[0], CONVRES_DECODE[1], CONVRES_DOWN]:
            args = convres_inputs(h, w, dtype, gen)
            with torch.no_grad():
                y = cr.fused_convres_block(*args, residual=True, scale=scale)
                want = cr.reference_impl(*args, residual=True, scale=scale)
                err = check_close(f"convres {h}x{w} scale={scale}", y, want, dtype)
                run = lambda: cr.fused_convres_block(*args, residual=True,
                                                     scale=scale)
                ms = cuda_ms(run, 5)
                plain_ms = cuda_ms(lambda: cr.reference_impl(
                    *args, residual=True, scale=scale), 5)
                gms = graph_ms(run, 5)
            cost = cr.cost(B, h, w, 64, args[0].element_size(), scale)
            bnd, by = bound_ms(cost, dtype)
            log(f"    convres {h}x{w} scale={scale} {dtype}: kernel "
                f"{ms * 1e3:.1f} us ({gms * 1e3:.1f} from a CUDA graph), plain "
                f"{plain_ms * 1e3:.1f} us, bound {bnd * 1e3:.1f} us ({by})")
            if dtype == torch.bfloat16 and scale != "down":
                sites = sum(1 for s in CONVRES_DECODE if s == (h, w, scale))
                accumulate(results, "convres_fwd", "x2_sample", sites, ms,
                           plain_ms, bnd, cost, err, graph_ms=gms)


GRAD_NAMES = ["dx", "dw1", "db1", "dw2", "db2", "dw3", "db3", "dw4", "db4"]


def phase_convres_bwd(results):
    """K3's ptxas line (no spill allowed); K3 against backward_reference
    at the five training shapes (B_REC recon rows), bf16 and f32; times
    both (bf16 also replayed from a CUDA graph).  Also checks and times
    K2 at the training shapes (bf16): its 9 launches at B_REC and 4 at
    B_TRAIN per micro-batch.  Both per train step of two micro-batches."""
    # no spill in the bf16 kernel (tc::convres_bwd_kernel, one per cio);
    # the f32 FMA kernel, the first design and on no default path, is
    # printed only
    bf16 = [k for k in ptxas_log("convres_bwd")
            if "tc18convres_bwd_kernel" in k["kernel"]]
    assert len(bf16) == 3, bf16
    for k in bf16:
        assert k["spill_stores"] == k["spill_loads"] == 0, k
    gen = torch.Generator(device="cuda").manual_seed(2)
    shares = {}
    for dtype in (torch.bfloat16, torch.float32):
        log(f"ConvResBlock backward (K3), B={B_REC}, {dtype}:")
        for (h, w, scale), n in TRAIN_BLOCKS:
            args = convres_inputs(h, w, dtype, gen, bsz=B_REC)
            dy = torch.randn((B_REC, h, w, 64), generator=gen,
                             device="cuda").to(dtype)
            got = cr._bwd_kernel(*args, dy, True)
            want = cr.backward_reference(*args, dy, True)
            errs = [check_close(f"convres_bwd {h}x{w} ({scale}) {name}", g, t,
                                dtype, quiet=True)
                    for name, g, t in zip(GRAD_NAMES, got, want)]
            err = max(errs)
            share = max(e / tolerance(t, dtype) for e, t in zip(errs, want))
            shares[dtype] = max(shares.get(dtype, 0.0), share)
            run = lambda: cr._bwd_kernel(*args, dy, True)
            ms = cuda_ms(run, 3)
            plain_ms = cuda_ms(lambda: cr.backward_reference(*args, dy, True), 3)
            cost = cr.cost_bwd(B_REC, h, w, 64, args[0].element_size())
            bnd, by = bound_ms(cost, dtype)
            if dtype == torch.bfloat16:
                gms = graph_ms(run, 3)
                lib = cudnn_block_ms(B_REC, h, 64, cr.MID_CHANNELS, True)
                log(f"    convres_bwd {h}x{w} ({scale}) {dtype}: kernel "
                    f"{ms * 1e3:.1f} us ({gms * 1e3:.1f} from a CUDA graph), "
                    f"plain {plain_ms * 1e3:.1f} us, bound {bnd * 1e3:.1f} us "
                    f"({by}), cuDNN's 11 convs {lib * 1e3:.1f} us; 9 gradients "
                    f"ok, max abs err {err:.3e}, at most {share:.1%} of its "
                    f"tolerance")
                # per train step: 2 micro-batches, n launches of this shape
                accumulate(results, "convres_bwd", "x3_train", 2 * n, ms,
                           plain_ms, bnd, cost, err, library_ms=lib, graph_ms=gms)
            else:
                log(f"    convres_bwd {h}x{w} ({scale}) {dtype}: kernel "
                    f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, bound "
                    f"{bnd * 1e3:.1f} us ({by}); 9 gradients ok, max abs err "
                    f"{err:.3e}, at most {share:.1%} of its tolerance")
    k3 = results[("convres_bwd", "x3_train")]
    log(f"  K3 at the training shapes, per train step ({2 * BWD_PER_MB} "
        f"launches, bf16): kernel {k3['ms']:.2f} ms ({k3['graph_ms']:.2f} from "
        f"CUDA graphs), plain {k3['plain_ms']:.2f} ms, bound "
        f"{k3['bound_ms']:.3f} ms, cuDNN's convs {k3['library_ms']:.2f} ms; "
        f"the largest share of its tolerance "
        f"{shares[torch.bfloat16]:.1%} (bf16), {shares[torch.float32]:.1%} "
        f"(f32)")
    with torch.no_grad():
        for bsz, blocks in ((B_REC, TRAIN_BLOCKS), (B_TRAIN, TRAIN_BLOCKS[:3])):
            for (h, w, scale), n in blocks:
                n = 2 if (bsz == B_TRAIN and scale is None) else n
                args = convres_inputs(h, w, torch.bfloat16, gen, bsz=bsz)
                run = lambda: cr.fused_convres_block(*args, residual=True,
                                                     scale=scale)
                plain = lambda: cr.reference_impl(*args, residual=True,
                                                  scale=scale)
                err = check_close(f"convres B={bsz} {h}x{w} scale={scale}",
                                  run(), plain(), torch.bfloat16, quiet=True)
                cost = cr.cost(bsz, h, w, 64, 2, scale)
                bnd, by = bound_ms(cost, torch.bfloat16)
                ms, plain_ms = cuda_ms(run, 3), cuda_ms(plain, 3)
                gms = graph_ms(run, 3)
                log(f"    convres B={bsz} {h}x{w} scale={scale} bf16: kernel "
                    f"{ms * 1e3:.1f} us ({gms * 1e3:.1f} from a CUDA graph), "
                    f"plain {plain_ms * 1e3:.1f} us, bound {bnd * 1e3:.1f} us "
                    f"({by}), {2 * n} launches a train step, max abs err "
                    f"{err:.3e}")
                accumulate(results, "convres_fwd", "x3_train", 2 * n, ms,
                           plain_ms, bnd, cost, err, graph_ms=gms)
    k2 = results[("convres_fwd", "x3_train")]
    log(f"  K2 at the training shapes, per train step (26 launches, bf16): "
        f"kernel {k2['ms']:.2f} ms ({k2['graph_ms']:.2f} from CUDA graphs), "
        f"plain {k2['plain_ms']:.2f} ms, "
        f"bound {k2['bound_ms']:.3f} ms, max abs err {k2['max_abs_err']:.3e}")


COUNTERS = (ab.LAUNCHES, cr.LAUNCHES, c3.LAUNCHES, wg.LAUNCHES, la.LAUNCHES,
            qt.LAUNCHES, probe_p1.LAUNCHES, probe_p2.LAUNCHES, probe_p3.LAUNCHES,
            probe_p4.LAUNCHES)
PROBES = (probe_p1, probe_p2, probe_p3, probe_p4)


def reset_counts():
    for d in COUNTERS:
        for k in d:
            d[k] = 0


def counts() -> dict:
    return {k: v for d in COUNTERS for k, v in d.items()}


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
    assert launched["attn_1pass"] == 0, launched
    for (name, path), r in results.items():
        if path == "x2_sample":
            r["launches"] = launched[name]
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
    for key, cat in (("int8_conv", "Q1 int8_conv"), ("lin_", "K4 linear attention"),
                     ("block_1p", "K1c attn_1pass"),
                     ("ctx_partial", "K1a attn_ctx"), ("ctx_reduce", "K1a attn_ctx"),
                     ("ctx_mma", "K1a attn_ctx"), ("out_mma", "K1b attn_out"),
                     ("out_kernel", "K1b attn_out"),
                     ("conv3x3_kernel", "K5 conv3x3"),
                     ("winograd_kernel", "K6 winograd"),
                     ("convres_general", "K2/K3 general"),
                     ("convres_bwd", "K3 convres_bwd"), ("convres", "K2 convres"),
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


def device_profile(run, steps: int, label: str):
    """torch.profiler over `run` (which takes `steps` steps): wall and
    device-busy ms per step, the device's idle share of its window, and
    kernel time by category and by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"profile, {label}: the profiler saw no device time (not measured)")
        return None
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
    log(f"profile, {label}: wall {wall_ms / steps:.2f} ms/step, device busy "
        f"{busy / 1e3 / steps:.2f} ms/step, idle share of the device window "
        f"{1 - busy / window:.3f}, {len(kernels) // steps} kernels/step "
        f"[{card_line()}]")
    for cat, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        log(f"  {cat:14s} {us / 1e3 / steps:8.3f} ms/step  {us / total:6.1%}")
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    log("  top kernels:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"    {us / 1e3 / steps:7.3f} ms/step  {name[:100]}")
    return by_cat, total, busy / 1e3 / steps, 1 - busy / window


# the main path's batch: bench.py:_sample_config(192), the bulk sampler
B_BULK = 192


def phase_profile(process, steps: int = 3):
    """Where a chain step's device time goes, over `steps` steps at B and
    over 2 steps at the bulk sampler's B_BULK; K1's share of each."""
    for bsz, n in ((B, steps), (B_BULK, 2)):
        z = process.init_latent(bsz, seed=11)
        ts = list(range(900, 900 - n, -1))
        process.p_sample_chain(z, ts, seed=11)
        prof = device_profile(lambda: process.p_sample_chain(z, ts, seed=11), n,
                              f"{n} chain steps at B={bsz} (bf16)")
        if prof is not None:
            by_cat, total = prof[:2]
            k1 = sum(by_cat.get(k, 0.0) for k in ("K1a attn_ctx", "K1b attn_out"))
            log(f"  K1 (K1a + K1b) at B={bsz}: {k1 / 1e3 / n:.3f} ms/step, "
                f"{k1 / total:.2%} of device time")
        del z
        torch.cuda.empty_cache()


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


def recon_rows(seed: int, steps: int, start: int = 0) -> list:
    """Rows under the recon gate of each (step, micro-batch), from the t
    the trainer draws: key fold_seed(fold_seed(seed, step), i)."""
    T, gate = X3_CONFIG["T"], X3_CONFIG["t_rec_max"]
    return [[int((draw_t(fold_seed(fold_seed(seed, s), i), B_TRAIN, T)
                  < gate).sum()) for i in range(2)]
            for s in range(start, start + steps)]


def pick_seed() -> tuple:
    """The first seed whose TRAIN_STEPS steps have a micro-batch with
    recon rows and one without, so both launch counts are checked."""
    for seed in range(1000):
        rows = recon_rows(seed, TRAIN_STEPS)
        flat = [n for r in rows for n in r]
        if min(flat) == 0 and max(flat) > 0:
            return seed, rows
    raise AssertionError("no seed gives both kinds of micro-batch")


def phase_train(results):
    """The x3 training path through setup_trainer -> train(), with the
    launch counters zeroed just before and read just after."""
    seed, rows = pick_seed()
    trainer, config = setup_trainer(dict(X3_CONFIG, n_steps=TRAIN_STEPS),
                                    mute=True, seed=seed, workdir=WORKDIR)
    log(f"main path: x3 dDDPM training, B={B_TRAIN} x accumulation 2, bf16, "
        f"{config['model_size']} params, seed {seed}: recon rows per "
        f"micro-batch {rows}")
    before = {k: p.detach().clone() for k, p in trainer.state.params.items()}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    losses = trainer.train()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launched = counts()
    log(f"  launches: {launched} in {TRAIN_STEPS} steps ({wall:.2f} s, the "
        f"first step's set-up included)")
    flat = [n for r in rows for n in r]
    want = {"attn_ctx": 2 * TRAIN_STEPS, "attn_out": 2 * TRAIN_STEPS,
            "convres_fwd": sum(FWD_PER_MB if n else FWD_NO_ROWS for n in flat),
            "convres_bwd": sum(BWD_PER_MB if n else 0 for n in flat)}
    assert {k: launched[k] for k in want} == want, (launched, want)
    assert not any(v for k, v in launched.items() if k not in want), launched
    for (name, path), r in results.items():
        if path == "x3_train":
            r["launches"] = launched[name]
    assert len(losses) == TRAIN_STEPS and np.isfinite(losses).all(), losses
    unchanged = [k for k, p in trainer.state.params.items()
                 if torch.equal(p, before[k])]
    assert not unchanged, f"params not updated: {unchanged[:5]}"
    log(f"  train_obj {losses}; every one of {len(before)} param tensors "
        f"updated")

    # checkpoint round trip into a fresh state
    net2, _, _, _ = build_model(X3_CONFIG)
    state2 = create_train_state(net2, create_optimizer(net2, X3_CONFIG["lr"]),
                                seed=0)
    checkpoint.restore_checkpoint(trainer.checkpoint_dir, state2)
    assert state2.step == TRAIN_STEPS and state2.seed == seed
    for k, p in trainer.state.params.items():
        assert torch.equal(p, state2.params[k]), k
        assert torch.equal(trainer.state.ema_params[k], state2.ema_params[k]), k
    for p, p2 in zip(trainer.opt.params, state2.opt.params):
        st, st2 = trainer.opt.adam.state[p], state2.opt.adam.state[p2]
        assert torch.equal(st["exp_avg"], st2["exp_avg"])
        assert torch.equal(st["exp_avg_sq"], st2["exp_avg_sq"])
    ema = checkpoint.load_model_params(trainer.checkpoint_dir)
    assert all(torch.equal(ema[k].cuda(), v)
               for k, v in trainer.state.ema_params.items())
    log("  checkpoint round trip: params, EMA, Adam moments, step, seed equal")
    del net2, state2

    # steady steps: a warm-up first (each new count of recon rows gives
    # the plain-path convs new shapes, whose first call sets cuDNN up),
    # then a timed window and one profiled step
    n_warm, n_timed = 6, 10
    start = TRAIN_STEPS + n_warm
    timed_rows = recon_rows(seed, n_timed + 1, start=start)
    for _ in range(n_warm):
        trainer.train_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        trainer.train_step()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_timed
    mean_rows = np.mean(timed_rows[:n_timed])
    log(f"  timed {n_timed} steps after {n_warm} warm-up steps (recon rows "
        f"{timed_rows[:n_timed]}, mean {mean_rows:.2f} per micro-batch): "
        f"{dt * 1e3:.1f} ms/step, {2 * B_TRAIN / dt:.1f} train imgs/s "
        f"[{card_line()}]")
    device_profile(trainer.train_step, 1,
                   f"1 train step at B={B_TRAIN} x 2 (bf16), recon rows "
                   f"{timed_rows[n_timed]}")
    return trainer


def phase_train_against_cpu(seed: int = 5):
    """One f32 train step (B = 2, accumulation 2) on the card (the
    kernels) against the same weights, batch, t and eps on the CPU (the
    plain path): the mean clipped gradients and the metrics."""
    cfg = dict(X3_CONFIG, compute_dtype="float32", unet_dropout=0.0,
               batch_size=2)
    net_gpu, proc_gpu, init_fn, _ = build_model(cfg)
    init_fn(seed)
    net_cpu, proc_cpu, _, _ = build_model(cfg, device="cpu")
    net_cpu.load_state_dict({k: v.cpu() for k, v in net_gpu.state_dict().items()})
    gen = torch.Generator().manual_seed(seed)
    batch = torch.rand((2, 2, 256, 256, 3), generator=gen) * 2 - 1
    t = torch.tensor([[3, 700], [57, 12]])     # recon rows in both
    eps = torch.randn((2, 2, 32, 32, 8), generator=gen)
    grads, metrics = {}, {}
    for dev, net, proc in (("cuda", net_gpu, proc_gpu), ("cpu", net_cpu, proc_cpu)):
        net.train()
        state = create_train_state(net, create_optimizer(net, cfg["lr"]), seed=0)
        reset_counts()
        m = make_train_step(proc, 2, cfg["ema_decay"])(
            state, batch.to(dev), t=t, eps=eps.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            c = counts()
            assert (c["convres_fwd"], c["convres_bwd"], c["attn_ctx"]) == (26, 18, 2), c
        grads[dev] = {k: p.grad.detach().cpu() for k, p in state.params.items()}
        metrics[dev] = {k: float(v) for k, v in m.items()}
    err = max(float((grads["cuda"][k] - g).abs().max())
              for k, g in grads["cpu"].items())
    scale = max(float(g.abs().max()) for g in grads["cpu"].values())
    rel = {k: abs(metrics["cuda"][k] - v) / max(abs(v), 1e-12)
           for k, v in metrics["cpu"].items()}
    log(f"f32 train step, card vs CPU plain path (B=2, accumulation 2): "
        f"grads max_abs_err {err:.3e} of max |g| {scale:.3e}; metrics "
        f"{metrics['cuda']} vs {metrics['cpu']}, rel err "
        f"{max(rel.values()):.2e} (tol: grads 1e-3 of max |g|, metrics "
        f"1e-4 relative: f32 sums over 256^2 pixels in other orders)")
    assert err <= 1e-3 * scale and max(rel.values()) <= 1e-4


def seam_params(block, t_emb, dtype) -> dict:
    """The seam's weights of one of the model's ResnetBlocks (HWIO convs
    in `dtype`, f32 biases and GroupNorm params) and its time bias for
    the time embedding t_emb, in `dtype`, as the block adds it."""
    hwio = lambda conv: (conv.weight.detach().permute(2, 3, 1, 0)
                         .to(dtype).contiguous())
    f32 = lambda t: t.detach().float()
    b0, b1 = block.block0, block.block1
    with torch.no_grad():
        tb = block.time_proj(mish(t_emb)).to(dtype)
    return {"w1": hwio(b0.conv), "b1": f32(b0.conv.bias),
            "g1": f32(b0.norm.weight), "be1": f32(b0.norm.bias),
            "w2": hwio(b1.conv), "b2": f32(b1.conv.bias),
            "g2": f32(b1.norm.weight), "be2": f32(b1.norm.bias), "tb": tb}


def cudnn_conv(x, w, b):
    """One cuDNN call for the same 3x3 SAME conv (+ bias) on NHWC x and
    HWIO w: channels_last NCHW views, x's dtype (the library yardstick,
    used nowhere in the port)."""
    xc = x.permute(0, 3, 1, 2)
    wc = w.to(x.dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    bc = b.to(x.dtype)
    return lambda: F.conv2d(xc, wc, bc, padding=1)


def _seam_inputs(net, dtype, gen):
    """(x, p, hw, c) at each seam: x random NHWC activations, p the
    weights of the x2 UNet's ResnetBlock there, one time bias per sample
    from random timesteps through the model's own time MLP."""
    t = torch.randint(0, X2_CONFIG["T"], (B,), generator=gen, device="cuda")
    with torch.no_grad():
        t_emb = net.time_mlp(t)
    for hw, c, idx in SEAMS:
        x = torch.randn((B, hw, hw, c), generator=gen, device="cuda").to(dtype)
        yield x, seam_params(net.resnets[idx], t_emb, dtype), hw, c


def phase_seam(results, net):
    """K5 at the x2 ResnetBlock seams: checked in bf16 and f32, timed in
    bf16 with the gn-fold + post_bias prologue (the seam's) and the
    identity prologue, eager and from CUDA graphs, beside cuDNN."""
    ptxas_check("conv3x3")
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(21)
        log(f"x2 ResnetBlock seam (K5), B={B}, {dtype}:")
        for x, p, hw, c in _seam_inputs(net, dtype, gen):
            with torch.no_grad():
                check_close(f"seam_fused vs seam_plain {hw}^2 c{c}",
                            c3.seam_fused(x, p), c3.seam_plain(x, p), dtype)
                c1 = c3.plain(x, p["w1"], p["b1"])
                scale, shift = c3.gn_fold(c1, p["g1"], p["be1"])
                kw = dict(scale=scale, shift=shift, post_bias=p["tb"])
                w2, b2 = p["w2"], p["b2"]
                err = check_close(f"conv3x3 gn-fold prologue {hw}^2 c{c}",
                                  c3.conv3x3_fused(c1, w2, b2, **kw),
                                  c3.plain(c1, w2, b2, **kw), dtype)
                err = max(err, check_close(
                    f"conv3x3 identity {hw}^2 c{c}",
                    c3.conv3x3_fused(c1, w2, b2), c3.plain(c1, w2, b2), dtype))
                if dtype != torch.bfloat16:   # f32 is checked, not timed
                    continue
                conv = lambda: c3.conv3x3_fused(c1, w2, b2, **kw)
                conv_id = lambda: c3.conv3x3_fused(c1, w2, b2)
                lib = cudnn_conv(c1, w2, b2)
                ms, ms_id = cuda_ms(conv, 20), cuda_ms(conv_id, 20)
                lib_ms = cuda_ms(lib, 20)
                g_ms, g_lib_ms = graph_ms(conv, 20), graph_ms(lib, 20)
                plain_ms = cuda_ms(lambda: c3.plain(c1, w2, b2, **kw), 5)
                seam_ms = cuda_ms(lambda: c3.seam_fused(x, p), 5)
                seam_plain_ms = cuda_ms(lambda: c3.seam_plain(x, p), 5)
            cost = c3.cost(B, hw, hw, c, c, x.element_size(), prologue_arrays=3)
            bnd, by = bound_ms(cost, dtype)
            tf = lambda t: cost["flops"] / t / 1e9
            log(f"    conv3x3 {hw}^2 c{c} {dtype}: kernel {ms * 1e3:.1f} us "
                f"({tf(ms):.1f} TFLOP/s, {bnd / ms:.3f} of the bound, "
                f"{ms / lib_ms:.2f}x cuDNN), identity prologue "
                f"{ms_id * 1e3:.1f} us ({tf(ms_id):.1f} TFLOP/s), plain "
                f"{plain_ms * 1e3:.1f} us, cuDNN F.conv2d {lib_ms * 1e3:.1f} us, "
                f"bound {bnd * 1e3:.1f} us ({by}); from a CUDA graph: kernel "
                f"{g_ms * 1e3:.1f} us ({tf(g_ms):.1f} TFLOP/s, "
                f"{bnd / g_ms:.3f} of the bound), cuDNN {g_lib_ms * 1e3:.1f} us "
                f"({g_ms / g_lib_ms:.2f}x); whole seam fused "
                f"{seam_ms * 1e3:.1f} us, unfused {seam_plain_ms * 1e3:.1f} us")
            accumulate(results, "conv3x3", "x2_seam", 1, ms, plain_ms, bnd,
                       cost, err, lib_ms, identity_ms=ms_id, graph_ms=g_ms,
                       library_graph_ms=g_lib_ms)
    r = results[("conv3x3", "x2_seam")]
    for what, k, lib in (("eager", "ms", "library_ms"),
                         ("eager, identity prologue", "identity_ms",
                          "library_ms"),
                         ("from CUDA graphs", "graph_ms", "library_graph_ms")):
        log(f"  three seams' conv2, bf16, {what}: kernel {r[k] * 1e3:.1f} us, "
            f"cuDNN {r[lib] * 1e3:.1f} us ({r[k] / r[lib]:.2f}x), bound "
            f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_ms'] / r[k]:.3f} of it) "
            f"[{card_line()}]")
    # the path: the three seams, counted on their own
    gen = torch.Generator(device="cuda").manual_seed(21)
    seams = list(_seam_inputs(net, torch.bfloat16, gen))
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        outs = [c3.seam_fused(x, p) for x, p, _, _ in seams]
    torch.cuda.synchronize()
    launched = counts()
    assert launched["conv3x3"] == len(SEAMS), launched
    assert all(torch.isfinite(o).all() and o.shape == x.shape
               for o, (x, _, _, _) in zip(outs, seams))
    results[("conv3x3", "x2_seam")]["launches"] = launched["conv3x3"]
    log(f"  seams: {launched['conv3x3']} K5 launches, outputs finite")


def graph_ms(fn, iters: int) -> float:
    """Mean device ms of fn replayed from a CUDA graph (CUDA events over
    `iters` replays): the time of its kernels without the host's launch
    gaps between them, which at a few tens of us a call would hide them."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


def ptxas_log(name: str) -> list:
    """Prints the ptxas line of each kernel of csrc/<name>.cu (registers,
    spill bytes) from the log its build kept, and returns them."""
    report = _build.ptxas_report(name)
    for k in report:
        log(f"  ptxas {name}: {k['kernel']}: {k['registers']} registers, "
            f"{k['spill_stores']} bytes spill stores, {k['spill_loads']} "
            f"bytes spill loads")
    return report


def ptxas_check(name: str, kernel: str = ""):
    """ptxas_log(name); fails on a spill or when the log holds no
    `kernel` (by default `<name>_kernel`)."""
    report = ptxas_log(name)
    kernel = kernel or f"{name}_kernel"
    assert any(kernel in k["kernel"] for k in report), (kernel, report)
    for k in report:
        assert k["spill_stores"] == k["spill_loads"] == 0, k


def phase_winograd(results, net):
    """K6 at the x2 3x3 convs: the seams' shapes and conv1 weights."""
    ptxas_check("winograd")
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(22)
        log(f"x2 3x3 convs through Winograd (K6), B={B}, {dtype}:")
        for x, p, hw, c in _seam_inputs(net, dtype, gen):
            w, b = p["w1"], p["b1"]
            cost = wg.cost(B, hw, hw, c, c, x.element_size())
            bnd, by = bound_ms(cost, dtype)
            with torch.no_grad():
                err = max(check_close(
                    f"winograd {hw}^2 c{c} mish={m}",
                    wg.conv3x3_winograd(x, w, b, apply_mish=m),
                    wg.plain(x, w, b, m), dtype) for m in (True, False))
                conv = lambda: wg.conv3x3_winograd(x, w, b)
                ms, lib_ms = cuda_ms(conv, 20), cuda_ms(cudnn_conv(x, w, b), 20)
                plain_ms = cuda_ms(lambda: wg.plain(x, w, b), 5)
                g_ms = graph_ms(conv, 20)
                g_lib_ms = graph_ms(cudnn_conv(x, w, b), 20)
            log(f"    winograd {hw}^2 c{c} {dtype}: kernel {ms * 1e3:.1f} us "
                f"({cost['flops'] / ms / 1e9:.1f} TFLOP/s of Winograd products, "
                f"{bnd / ms:.3f} of the bound, {ms / lib_ms:.2f}x cuDNN), plain "
                f"{plain_ms * 1e3:.1f} us, cuDNN F.conv2d {lib_ms * 1e3:.1f} us, "
                f"bound {bnd * 1e3:.1f} us ({by}); from a CUDA graph: kernel "
                f"{g_ms * 1e3:.1f} us ({cost['flops'] / g_ms / 1e9:.1f} TFLOP/s, "
                f"{bnd / g_ms:.3f} of the bound), cuDNN {g_lib_ms * 1e3:.1f} us "
                f"({g_ms / g_lib_ms:.2f}x)")
            if dtype == torch.bfloat16:
                accumulate(results, "winograd", "x2_conv3x3", 1, ms, plain_ms,
                           bnd, cost, err, lib_ms, graph_ms=g_ms,
                           library_graph_ms=g_lib_ms)
    r = results[("winograd", "x2_conv3x3")]
    for what, k, lib in (("eager", "ms", "library_ms"),
                         ("from CUDA graphs", "graph_ms", "library_graph_ms")):
        log(f"  three convs, bf16, {what}: kernel {r[k] * 1e3:.1f} us, cuDNN "
            f"{r[lib] * 1e3:.1f} us ({r[k] / r[lib]:.2f}x), bound "
            f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_ms'] / r[k]:.3f} of it) "
            f"[{card_line()}]")
    gen = torch.Generator(device="cuda").manual_seed(22)
    convs = [(x, p["w1"], p["b1"]) for x, p, _, _ in
             _seam_inputs(net, torch.bfloat16, gen)]
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        outs = [wg.conv3x3_winograd(*a) for a in convs]
    torch.cuda.synchronize()
    launched = counts()
    assert launched["winograd"] == launched["winograd_weights"] == len(SEAMS), \
        launched
    assert all(torch.isfinite(o).all() for o in outs)
    results[("winograd", "x2_conv3x3")]["launches"] = launched["winograd"]
    log(f"  3x3 convs: {launched['winograd']} K6 launches, "
        f"{launched['winograd_weights']} of its weight transform, outputs finite")


def _site_qkv(net, dtype, gen):
    """(q, k, v, n, c) at each attention site: x random tokens, LN with
    the site's own norm, [q | k | v] = LN(x) @ the site's qkv weights."""
    for (n, c), idx in zip(ATTN_SITES, ATTN_SITE_MODULES):
        mod = net.attns[idx]
        x = torch.randn((B, n, c), generator=gen, device="cuda").to(dtype)
        with torch.no_grad():
            ln = ab.layer_norm_f32(x, mod.norm.g, mod.norm.b).to(dtype)
            w_qkv, _ = mod.attn.matrices(dtype)
            qkv = (ln @ w_qkv).reshape(B, n, 3, ab.HIDDEN)
        yield (*(qkv[:, :, i].contiguous() for i in range(3)), n, c)


def phase_linear_attention(results, net):
    """K4 at the x2 UNet's five attention sites above 512 tokens; its
    ptxas lines first (the bf16 kernels on mma.sync, the f32 FMA ones),
    no spill allowed."""
    ptxas_check("linear_attention", "lin_ctx_mma")
    assert any("lin_out_mma" in k["kernel"]
               for k in _build.ptxas_report("linear_attention"))
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(23)
        log(f"linear attention (K4) at the x2 attention sites, B={B}, {dtype}:")
        for q, k, v, n, c in _site_qkv(net, dtype, gen):
            with torch.no_grad():
                ctx = la.linear_attention_ctx(k, v)
                ctx_ref = la.ctx_plain(k, v)
                e_ctx = check_close(f"lin_ctx N={n} (C={c})", la.blocks_of(ctx),
                                    ctx_ref, torch.float32)
                out_ref = la.out_plain(q, ctx_ref)
                e_out = check_close(f"lin_out N={n} (C={c})",
                                    la.linear_attention_out(q, ctx), out_ref,
                                    dtype)
                check_close(f"linear_attention N={n} vs reference_impl",
                            la.linear_attention(q, k, v),
                            la.reference_impl(q, k, v), dtype)
                timings = {
                    "lin_ctx": (lambda: la.linear_attention_ctx(k, v),
                                lambda: la.ctx_plain(k, v), e_ctx),
                    "lin_out": (lambda: la.linear_attention_out(q, ctx),
                                lambda: la.out_plain(q, ctx_ref), e_out)}
                costs = la.cost(B, n, ab.HIDDEN, q.element_size())
                for name, (kern, plain, err) in timings.items():
                    ms, plain_ms = cuda_ms(kern, 20), cuda_ms(plain, 10)
                    bnd, by = bound_ms(costs[name], dtype)
                    gms = graph_ms(kern, 20) if dtype == torch.bfloat16 else None
                    graph = "" if gms is None else f" ({gms * 1e3:.1f} from a CUDA graph)"
                    log(f"    {name} N={n} {dtype}: kernel {ms * 1e3:.1f} us{graph}, "
                        f"plain {plain_ms * 1e3:.1f} us, bound "
                        f"{bnd * 1e3:.1f} us ({by})")
                    if dtype == torch.bfloat16:
                        accumulate(results, name, "x2_attn_sites", 1, ms,
                                   plain_ms, bnd, costs[name], err, graph_ms=gms)
    gen = torch.Generator(device="cuda").manual_seed(23)
    sites = list(_site_qkv(net, torch.bfloat16, gen))
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        outs = [la.linear_attention(q, k, v) for q, k, v, _, _ in sites]
    torch.cuda.synchronize()
    launched = counts()
    assert launched["lin_ctx"] == launched["lin_out"] == len(ATTN_SITES), launched
    assert all(torch.isfinite(o).all() for o in outs)
    for name in ("lin_ctx", "lin_out"):
        r = results[(name, "x2_attn_sites")]
        r["launches"] = launched[name]
        log(f"  {name}, five sites, bf16: kernel {r['ms']:.4f} ms eager, "
            f"{r['graph_ms']:.4f} from CUDA graphs, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms [{card_line()}]")
    log(f"  attention sites: {launched['lin_ctx']} launches of each K4 kernel, "
        f"outputs finite")
    # where K4's time goes: its three kernels' device time and the host's
    # share (the device's idle share) over ten passes of the five sites
    with torch.no_grad():
        device_profile(lambda: [la.linear_attention(q, k, v) for _ in range(10)
                                for q, k, v, _, _ in sites],
                       10, f"K4 at the five sites, B={B}, bf16 (a step: one pass)")


def phase_one_pass(results, process):
    """K1c per launch at the five sites (in bf16 its bits repeated across
    two launches, and its time beside the two-pass route's and their
    difference), then the x2 chain with FORCE_ONE_PASS set against the
    two-pass chain."""
    gen = torch.Generator(device="cuda").manual_seed(24)
    for dtype in (torch.bfloat16, torch.float32):
        log(f"one-pass attention block (K1c), {dtype}:")
        for n, c in sorted(set(ATTN_SITES), reverse=True):
            x, g, b, w_qkv, w_out, b_out = attn_inputs(n, c, dtype, gen)
            w_q, w_k, w_v = (w_qkv.reshape(c, 3, ab.HIDDEN)[:, i].contiguous()
                             for i in range(3))
            w_kv = torch.cat([w_k, w_v], dim=1).contiguous()
            one = lambda: ab.attention_1pass(x, g, b, w_kv, w_q, w_out, b_out)
            plain = lambda: ab.one_pass_reference(x, g, b, w_qkv, w_out, b_out)
            two = lambda: ab.attention_out(
                x, g, b, ab.fold_w_eff(w_q, ab.attention_ctx(x, g, b, w_kv),
                                       w_out, dtype), b_out)
            got = one()
            err = check_close(f"attn_1pass N={n} C={c}", got, plain(), dtype)
            check_close(f"attn_1pass N={n} C={c} vs two-pass route", got,
                        two(), dtype)
            if dtype == torch.bfloat16:
                assert torch.equal(one(), got), "K1c's bits differ between launches"
            ms, plain_ms, two_ms = cuda_ms(one, 20), cuda_ms(plain, 10), cuda_ms(two, 20)
            cost = ab.cost(B, n, c, x.element_size())["attn_1pass"]
            bnd, by = bound_ms(cost, dtype)
            log(f"    attn_1pass B={B} N={n} C={c} {dtype}: kernel "
                f"{ms * 1e3:.1f} us, two-pass route (A + fold + B) "
                f"{two_ms * 1e3:.1f} us, one pass - two passes "
                f"{(ms - two_ms) * 1e3:+.1f} us, plain {plain_ms * 1e3:.1f} us, "
                f"bound {bnd * 1e3:.1f} us ({by})")
            if dtype == torch.bfloat16:
                # from CUDA graphs: the device's time without the host's
                # gaps (the two-pass route's fold is several PyTorch calls)
                gms, two_gms = graph_ms(one, 20), graph_ms(two, 20)
                log(f"      from CUDA graphs: kernel {gms * 1e3:.1f} us, two-pass "
                    f"route {two_gms * 1e3:.1f} us, one pass - two passes "
                    f"{(gms - two_gms) * 1e3:+.1f} us")
                accumulate(results, "attn_1pass", "x2_sample_1pass",
                           ATTN_SITES.count((n, c)), ms, plain_ms, bnd, cost, err,
                           two_pass_ms=two_ms, graph_ms=gms, two_pass_graph_ms=two_gms)
    r = results[("attn_1pass", "x2_sample_1pass")]
    for what, k, k2 in (("eager", "ms", "two_pass_ms"),
                        ("from CUDA graphs", "graph_ms", "two_pass_graph_ms")):
        log(f"  attn_1pass, five sites, bf16, {what}: kernel {r[k]:.4f} ms, two-pass "
            f"route {r[k2]:.4f} ms, one pass - two passes {r[k] - r[k2]:+.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms [{card_line()}]")

    early_stop = X2_CONFIG["T"] - CHAIN_1P_STEPS
    run = lambda: generate_samples(process, seed=31, fid_samples=B, batch_size=B,
                                   early_stop=early_stop, progress=False)
    ab.FORCE_ONE_PASS = True
    torch.cuda.synchronize()
    reset_counts()
    samples_1p, latents_1p, timing = run()
    launched = counts()
    ab.FORCE_ONE_PASS = False
    log(f"main path, one pass: x2 chain of {CHAIN_1P_STEPS} steps + decode with "
        f"DDDPM_ATTN_ONE_PASS; launches: {launched}")
    assert launched["attn_1pass"] == 5 * CHAIN_1P_STEPS, launched
    assert launched["attn_ctx"] == launched["attn_out"] == 0, launched
    assert launched["convres_fwd"] == 3, launched
    results[("attn_1pass", "x2_sample_1pass")]["launches"] = launched["attn_1pass"]
    assert np.isfinite(samples_1p).all() and np.isfinite(latents_1p).all()
    samples_2p, latents_2p, _ = run()
    # both are fix_samples'd to [0, 255] per image; the routes compute the
    # same function with the same roundings, the partial sums of pass A
    # split differently: tolerance() of bf16
    for name, a, b_ in (("latents", latents_1p, latents_2p),
                        ("samples", samples_1p, samples_2p)):
        check_close(f"one-pass chain vs two-pass chain, {name} (0-255)",
                    torch.from_numpy(a), torch.from_numpy(b_), torch.bfloat16)
    log(f"  {timing['total_s']:.3f} s for {CHAIN_1P_STEPS} steps + decode "
        f"[{card_line()}]")


def phase_probes(results):
    """The path of the probes: each probe's main() at its default size,
    with the counters zeroed just before and read just after.  Each
    main() checks every variant against its plain version on the card
    before timing it, and raises on a mismatch."""
    ptxas_check("probe_attention", "probe_ctx_kernel")   # no kernel of it spills
    ptxas_check("probe_attention", "probe_out_kernel")
    ptxas_check("probe_cmajor_conv", "cmajor_conv_kernel")
    ptxas_check("probe_convres", "probe_convres_kernel")   # all 7 variants
    ptxas_check("probe_copy", "copy_async_kernel")
    ptxas_check("probe_copy", "copy_kernel")
    heads = {}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    for probe in PROBES:
        log(f"--- {probe.__name__} ---")
        heads.update(probe.main([]))
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launched = counts()
    names = [k for p in PROBES for k in p.LAUNCHES]
    # the shipped K1 and K2 launch too: P1 and P3 time them beside the
    # variants
    log(f"probes: {time.time() - t0:.1f} s; launches: {launched}")
    # K3 with parts compiled out (nothing checked, only timed; main()
    # builds its variants, one nvcc each, all at once)
    log("--- dddpm_tpu_torch.probes.convres_bwd_ablation ---")
    k3_ablation.main([])
    # K1a / K1b likewise, at the x2 sites; then, checked against the
    # plain versions, the two bf16 routes at the 512-channel sites: the
    # shipped tensor-core kernels (weights streamed in K-slabs) and the
    # FMA kernels
    log("--- dddpm_tpu_torch.probes.attention_ablation ---")
    k1_ablation.main([])
    for name in names:
        assert launched[name] > 0, (name, launched)
        h = heads[name]
        bnd, _ = bound_ms(h["cost"], torch.bfloat16)
        results[(name, "probes")] = dict(
            ms=h["ms"], plain_ms=h["plain_ms"], bound_ms=bnd,
            max_abs_err=h["max_abs_err"], bytes=h["cost"]["bytes"],
            flops=h["cost"]["flops"], launches=launched[name],
            library_ms=h["library_ms"],
            **{k: h[k] for k in ("library_cl_ms", "shipped_ms") if k in h})


# phase 11: the x2 checkpoint the evaluation path reads; X2_CONFIG on
# synthetic 256^2 images (the same widths: 3 colour channels), which the
# card's machine can make, with an EMA and bench.py's lr
X2_EVAL_CONFIG = dict(X2_CONFIG, dataset="synthetic", ema_decay=0.995,
                      lr=2e-4, rnd_flip=False, val_split=0)
DDIM_STEPS = 50
RESUME_STEPS = 2
INCEPTION_PASSES = 11   # 2112 images timed
EVAL_DIR = os.path.join(WORKDIR, "eval")


def predicted_fused_blocks(module, shape) -> int:
    """ConvResBlocks of `module` that fused_shape_ok admits at the shapes
    one NCHW call on `shape` gives them (forward pre-hooks read each
    block's input; the call runs on the card)."""
    admitted = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: admitted.append(m.fused_shape_ok(*a[0].shape[2:])))
        for m in module.modules() if isinstance(m, ConvResBlock)]
    with torch.no_grad():
        module(torch.zeros(shape, device="cuda"))
    for h in hooks:
        h.remove()
    return sum(admitted)


def check_bulk_kernels() -> dict:
    """K1a/K1b at every x2 attention site and K2 at the x2 decode blocks,
    at the bulk sampler's B_BULK (the batch phase 11's DDIM run gives
    them; K1's plan takes another persistent-grid regime there), bf16,
    against their plain versions."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    dt, errs = torch.bfloat16, {}
    for n, c in sorted(set(ATTN_SITES), reverse=True):
        x, g, b, w_qkv, w_out, b_out = attn_inputs(n, c, dt, gen, B_BULK)
        w_q, w_k, w_v = (w_qkv.reshape(c, 3, ab.HIDDEN)[:, i] for i in range(3))
        w_kv = torch.cat([w_k, w_v], dim=1).contiguous()
        ctx_ref = ab.ctx_reference(x, g, b, w_kv)
        errs[f"attn_ctx N={n} C={c}"] = check_close(
            f"attn_ctx B={B_BULK} N={n} C={c}", ab.attention_ctx(x, g, b, w_kv),
            ctx_ref, dt)
        w_eff = ab.fold_w_eff(w_q, ctx_ref, w_out, dt)
        errs[f"attn_out N={n} C={c}"] = check_close(
            f"attn_out B={B_BULK} N={n} C={c}",
            ab.attention_out(x, g, b, w_eff, b_out),
            ab.out_reference(x, g, b, w_eff, b_out), dt)
        del x, ctx_ref
    for h, w, scale in sorted(set(CONVRES_DECODE), key=str):
        args = convres_inputs(h, w, dt, gen, B_BULK)
        with torch.no_grad():
            errs[f"convres {h}x{w} scale={scale}"] = check_close(
                f"convres B={B_BULK} {h}x{w} scale={scale}",
                cr.fused_convres_block(*args, residual=True, scale=scale),
                cr.reference_impl(*args, residual=True, scale=scale), dt)
        del args
    torch.cuda.empty_cache()
    return errs


def tile_rel_err(a: np.ndarray, b: np.ndarray, tf32: bool = False) -> float:
    """pairwise_sq_dists on the card against float64 numpy, its largest
    error over the largest distance.  tf32=True is the control: the same
    function with its full-f32 pin taken out and TF32 on globally."""
    exact = ((a[:, None].astype(np.float64) - b[None]) ** 2).sum(-1)
    ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    if tf32:
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with mock.patch.object(prec_recall, "full_f32", contextlib.nullcontext):
                d = pairwise_sq_dists(ta, tb)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
    else:
        d = pairwise_sq_dists(ta, tb)
    return float(np.abs(d.cpu().numpy() - exact).max() / exact.max())


def phase_eval(ckpt_x3: str, seed_x3: int):
    """The evaluation path through the entry points a user calls."""
    os.makedirs(EVAL_DIR, exist_ok=True)
    out = {"card": card_line()}

    # resume: phase 5's x3 checkpoint, 2 more steps
    step0 = checkpoint.load_step(ckpt_x3)
    rows = [n for r in recon_rows(seed_x3, RESUME_STEPS, start=step0) for n in r]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    resumed = resume_main.main(["--checkpoint", ckpt_x3, "--steps",
                                str(step0 + RESUME_STEPS), "-mute"])
    torch.cuda.synchronize()
    launched = counts()
    want = {"attn_ctx": 2 * RESUME_STEPS, "attn_out": 2 * RESUME_STEPS,
            "convres_fwd": sum(FWD_PER_MB if n else FWD_NO_ROWS for n in rows),
            "convres_bwd": sum(BWD_PER_MB if n else 0 for n in rows)}
    log(f"eval path, resume: x3 from step {step0}, {RESUME_STEPS} steps "
        f"({time.time() - t0:.2f} s with set-up); recon rows {rows}; "
        f"launches {launched}")
    assert resumed.step == step0 + RESUME_STEPS, resumed.step
    new = resumed.train_losses[-RESUME_STEPS:]
    assert len(resumed.train_losses) == step0 + RESUME_STEPS
    assert np.isfinite(new).all(), new
    assert {k: launched[k] for k in want} == want, (launched, want)
    assert not any(v for k, v in launched.items() if k not in want), launched
    out["resume"] = {"steps": RESUME_STEPS, "train_obj": new,
                     "launches": {k: launched[k] for k in want}}
    del resumed
    torch.cuda.empty_cache()

    # a full-width x2 checkpoint, random init
    net, _, init_fn, config = build_model(X2_EVAL_CONFIG)
    init_fn(0)
    ckpt_x2 = checkpoint.save_checkpoint(
        os.path.join(EVAL_DIR, "x2_ddim"),
        create_train_state(net, create_optimizer(net, config["lr"]), seed=0),
        config)
    k2_down = predicted_fused_blocks(net.downsample, (1, 3, 256, 256))
    k2_up = predicted_fused_blocks(net.upsample, (1, 8, 128, 128))
    del net
    torch.cuda.empty_cache()

    # generate: DDIM-50 at the bulk sampler's batch
    torch.cuda.synchronize()
    reset_counts()
    samples, _, timing = generate_main.main(
        ["--checkpoint", ckpt_x2, "--ddim-steps", str(DDIM_STEPS),
         "--fid-samples", str(B_BULK), "--batch-size", str(B_BULK),
         "--out", os.path.join(EVAL_DIR, "samples"),
         "--latent-out", os.path.join(EVAL_DIR, "samples_latent")])
    launched = counts()
    log(f"eval path, generate: DDIM-{DDIM_STEPS} + decode at B={B_BULK}, "
        f"{timing['total_s']:.3f} s, {timing['imgs_per_sec']:.3f} imgs/s "
        f"(the first batch of the process at these shapes) [{out['card']}]; "
        f"launches {launched}")
    assert samples.shape == (1, B_BULK, 256, 256, 3), samples.shape
    assert np.isfinite(samples).all()
    assert samples.min() >= 0.0 and samples.max() <= 255.0
    assert launched["attn_ctx"] == launched["attn_out"] == 5 * DDIM_STEPS, launched
    # one K2 launch a decoder block, whatever the batch (ops/convres.py)
    assert launched["convres_fwd"] == k2_up == 3, (launched, k2_up)
    assert not any(v for k, v in launched.items()
                   if k not in ("attn_ctx", "attn_out", "convres_fwd")), launched
    out["generate"] = {"ddim_steps": DDIM_STEPS, "batch": B_BULK,
                       "total_s": timing["total_s"],
                       "imgs_per_sec": timing["imgs_per_sec"],
                       "launches": launched}
    samples_npy = os.path.join(EVAL_DIR, "samples", "x2_ddim.npy")
    del samples
    out["generate"]["kernels_at_batch"] = check_bulk_kernels()

    # the reference batch
    ref_npy = ref_batch_main.main(
        ["-d", "synthetic", "-is", "256", "--n", str(B_BULK), "--bs", str(B),
         "--out", os.path.join(EVAL_DIR, "reference")])

    # evaluate: one B = 8 batch of the full test-set VLB, then the metrics
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    metrics, ev_timing = evaluate_main.main(
        ["--checkpoint", ckpt_x2, "--samples", samples_npy, "--reference",
         ref_npy, "--allow-random-inception", "--test-batches", "1"])
    launched = counts()
    T = X2_EVAL_CONFIG["T"]
    log(f"eval path, evaluate: {time.time() - t0:.1f} s; test losses "
        f"{ev_timing['test_losses_s']:.3f} s for one B={B} batch of the "
        f"{T}-t VLB ({ev_timing['test_losses_s'] / T * 1e3:.2f} ms a t) "
        f"[{out['card']}]; launches {launched}; K2 predicted for the "
        f"downsampler {k2_down}")
    assert launched["attn_ctx"] == launched["attn_out"] == 5 * T, launched
    assert launched["convres_fwd"] == k2_down, (launched, k2_down)
    assert not any(v for k, v in launched.items()
                   if k not in ("attn_ctx", "attn_out", "convres_fwd")), launched
    for k in ("vlb", "L_simple", "is", "precision", "recall"):
        assert np.isfinite(metrics[k]), (k, metrics)
    # FID / sFID may be NaN: 192 samples in 2048-d (tests/test_evaluation.py)
    assert all(np.isfinite(metrics[k]) or np.isnan(metrics[k])
               for k in ("fid", "sfid")), metrics
    assert metrics["inception_weights"] == "random-init"
    out["evaluate"] = {"test_losses_s": ev_timing["test_losses_s"],
                       "test_batch": B, "T": T, "metrics": metrics,
                       "launches": launched}

    # compare: the reference batch against itself
    same = compare_main.main(["--batch1", ref_npy, "--batch2", ref_npy,
                              "--allow-random-inception"])
    assert abs(same["fid"]) < 1e-3, same
    assert same["precision"] == 1.0 and same["recall"] == 1.0, same
    out["compare_self"] = same

    # Inception on the card: imgs/s, and its heads against the CPU's
    fe = FeatureExtractor()
    fe(ref_npy)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(INCEPTION_PASSES):
        acts = fe(samples_npy)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_imgs = INCEPTION_PASSES * B_BULK
    log(f"eval path, Inception: {n_imgs / dt:.1f} imgs/s ({INCEPTION_PASSES} "
        f"passes over {B_BULK} images of 256^2 from the npy, {n_imgs} in "
        f"{dt:.3f} s, batch {fe.batch_size}, f32, TF32 off) [{out['card']}]")
    out["inception_imgs_per_sec"] = n_imgs / dt
    out["inception_images_timed"] = n_imgs
    imgs = np.load(ref_npy, mmap_mode="r").reshape(-1, 256, 256, 3)[:8]
    want = FeatureExtractor(device="cpu")(imgs)
    got = fe(imgs)
    errs = {}
    for k in ("pool3", "spatial", "softmax"):
        errs[k] = float(np.abs(got[k] - want[k]).max())
        tol = 1e-3 * float(np.abs(want[k]).max())
        log(f"  Inception {k}, card vs CPU (8 images, f32): max_abs_err "
            f"{errs[k]:.3e} (tol {tol:.3e})")
        assert errs[k] <= tol, (k, errs[k], tol)
    # the tile on the pool3 features, and on features with pool3's large
    # common offset (1 + 0.3 randn), where the form cancels: there the
    # control without the full-f32 pin must miss the limit, or the check
    # could not see a TF32 product
    rng = np.random.RandomState(13)
    tiles = {"pool3": (acts["pool3"], fe(ref_npy)["pool3"]),
             "offset": ((1 + 0.3 * rng.randn(512, 2048)).astype(np.float32),
                        (1 + 0.3 * rng.randn(512, 2048)).astype(np.float32))}
    pair = {}
    for k, (a, b) in tiles.items():
        pair[k] = {"rel_err": tile_rel_err(a, b),
                   "tf32_control_rel_err": tile_rel_err(a, b, tf32=True)}
        log(f"  pairwise tile {k}, {a.shape[0]} x {b.shape[0]} x 2048 on the "
            f"card vs float64 numpy: max err {pair[k]['rel_err']:.3e} of the "
            f"largest (tol 1e-4); control with TF32 "
            f"{pair[k]['tf32_control_rel_err']:.3e}")
        assert pair[k]["rel_err"] <= 1e-4, (k, pair[k])
    assert pair["offset"]["tf32_control_rel_err"] > 1e-4, pair
    out["card_vs_cpu"] = {"inception_max_abs_err": errs, "pairwise": pair}
    print(json.dumps({"eval_path": out}), flush=True)


# phase 12: the int8 serving mode (--quant-conv int8).  The x2 UNet's
# quantized 3x3 convs by shape class (H = W, C, single-operand launches,
# two-operand launches) of one UNet eval: 32 operands in 30 launches, as
# the decoder's 32^2 and 16^2 skip seams quantize x and the skip apart
# but run them in one launch
INT8_CLASSES = [(128, 128, 4, 0), (64, 256, 3, 0), (64, 128, 3, 0),
                (32, 256, 7, 1), (16, 256, 11, 1)]
INT8_LAUNCHES = sum(n1 + n2 for _, _, n1, n2 in INT8_CLASSES)          # 30
INT8_OPERANDS = sum(n1 + 2 * n2 for _, _, n1, n2 in INT8_CLASSES)      # 32
# calibration's eps evals at T = 1000, n_points 16: x_init and the 15
# chain snapshots (every 62 steps) with t_last - 1 >= 0
INT8_CAL_EVALS = 16
# the x2 UNet's three Upsamples (H = W of the input, C)
UPSAMPLES = [(16, 256), (32, 256), (64, 128)]
PER[("int8_conv", "x2_sample_int8")] = (
    f"x2 chain step at B={B} with --quant-conv int8: {INT8_LAUNCHES} launches, "
    f"{INT8_OPERANDS} operands (" + ", ".join(
        f"{n1 + 2 * n2} at {hw}^2 c{c}" for hw, c, n1, n2 in INT8_CLASSES)
    + "), on NCHW operands; library_ms: F.conv2d in bf16 on NCHW, "
    "library_cl_ms on channels_last, one call per launch")


def int8_inputs(hw, c, dtype, gen, bsz, skip):
    """((x, qw, amax), kwargs, w) of one Q1 launch at a quantized conv's
    shape, channels_last: x ~ 2 N(0, 1), kaiming-scale weights, amax
    below max |x| (a few values saturate), a bias, and with `skip` a
    second operand; w is the float kernel over x's (and the skip's)
    channels, the float site's."""
    r = lambda *sh: torch.randn(*sh, generator=gen, device="cuda")
    cl = torch.channels_last
    x = (2.0 * r(bsz, c, hw, hw)).to(dtype).contiguous(memory_format=cl)
    w = r(c, c, 3, 3) / (9 * c) ** 0.5
    kw = {"bias": 0.1 * r(c)}
    if skip:
        sk = (3.0 * r(bsz, c, hw, hw)).to(dtype).contiguous(memory_format=cl)
        w2 = r(c, c, 3, 3) / (9 * c) ** 0.5
        kw.update(skip=sk, qw_skip=qt.prepare_weight(w2),
                  amax_skip=sk.float().abs().amax() * 0.9)
        w = torch.cat([w, w2], dim=1)
    return (x, qt.prepare_weight(w[:, :c]), x.float().abs().amax() * 0.9), kw, w


def _as_layout(args, kw, fmt):
    """The launch's operands copied into memory format fmt."""
    x = args[0].contiguous(memory_format=fmt)
    kw = dict(kw)
    if "skip" in kw:
        kw["skip"] = kw["skip"].contiguous(memory_format=fmt)
    return (x,) + tuple(args[1:]), kw


INT8_LAYOUTS = (("nchw", torch.contiguous_format), ("cl", torch.channels_last))


def phase_int8_kernel(results) -> dict:
    """Q1's ptxas lines (every instantiation, no spill); then at B and at
    B_BULK, at the five shape classes with and without a skip operand:
    Q1 against its plain version, bit for bit, on NCHW and on
    channels_last operands (and, at B, x and the skip in different
    layouts), the output NCHW-contiguous; Q1 timed on both layouts
    beside its bound and F.conv2d bf16 (the call the site makes without
    int8) on the same layout.  The kernels line takes the B times on
    NCHW operands, the layout the path hands 24 of a UNet eval's 30
    launches (library_cl_ms: F.conv2d on channels_last)."""
    ptxas_check("int8_conv", "int8_conv_kernel")
    gen = torch.Generator(device="cuda").manual_seed(12)
    dt, out = torch.bfloat16, {}
    for bsz in (B, B_BULK):
        iters = 50 if bsz == B else 10
        for hw, c, n1, n2 in INT8_CLASSES:
            for skip, n in ((False, n1), (True, n2)):
                args, kw, w = int8_inputs(hw, c, dt, gen, bsz, skip)
                want = qt.plain(*args, **kw)
                pms = cuda_ms(lambda: qt.plain(*args, **kw), 2) if bsz == B else None
                wb, bb = w.to(dt), kw["bias"].to(dt)
                cost = qt.cost(bsz, hw, hw, c, c, 2, operands=2 if skip else 1)
                bnd, by = bound_ms(cost, torch.int8)
                key = f"{hw}^2 c{c}{' +skip' if skip else ''} B={bsz}"
                row = {"launches_per_eval": n, "bound_ms": bnd, "bound_by": by,
                       "plain_ms": pms}
                cases = list(INT8_LAYOUTS)
                if skip and bsz == B:
                    cases.append(("mixed", None))
                for name, fmt in cases:
                    if fmt is None:     # x NCHW, the skip as made: channels_last
                        a_, k_ = (args[0].contiguous(),) + args[1:], kw
                    else:
                        a_, k_ = _as_layout(args, kw, fmt)
                    got = qt.int8_conv_q(*a_, **k_)
                    err = float((got.float() - want.float()).abs().max())
                    assert torch.equal(got, want), (key, name, err)
                    assert got.is_contiguous() and got.dtype == dt, (key, name)
                    if fmt is None:
                        continue
                    xin = (torch.cat([a_[0], k_["skip"]], dim=1) if skip
                           else a_[0]).contiguous(memory_format=fmt)
                    ms = cuda_ms(lambda: qt.int8_conv_q(*a_, **k_), iters, reps=3)
                    lib = cuda_ms(lambda: F.conv2d(xin, wb, bb, padding=1), iters,
                                  reps=3)
                    row[name] = {"ms": ms, "library_ms": lib,
                                 "share_of_bound": bnd / ms,
                                 "library_over_q1": lib / ms}
                    del xin, got
                if bsz == B:
                    accumulate(results, "int8_conv", "x2_sample_int8", n,
                               row["nchw"]["ms"], pms, bnd, cost, 0.0,
                               library_ms=row["nchw"]["library_ms"],
                               library_cl_ms=row["cl"]["library_ms"])
                out[key] = row
                log(f"  Q1 {key}: NCHW {row['nchw']['ms'] * 1e3:.1f} us, channels_last "
                    f"{row['cl']['ms'] * 1e3:.1f} us (bound {bnd * 1e3:.1f} us, {by}; "
                    f"{bnd / row['nchw']['ms']:.1%} / {bnd / row['cl']['ms']:.1%}); "
                    f"F.conv2d bf16 NCHW {row['nchw']['library_ms'] * 1e3:.1f} us, "
                    f"channels_last {row['cl']['library_ms'] * 1e3:.1f} us; equal to "
                    f"its plain version [{card_line()}]")
                del args, kw, w, want
                torch.cuda.empty_cache()
    results[("int8_conv", "x2_sample_int8")]["dtype"] = torch.int8
    return out


def phase_int8_profile() -> dict:
    """Two chain steps at B_BULK of the x2 UNet (random init, noise
    calibration at batch 4) per label, int8 and bf16 on the same
    weights, each profiled: device busy, idle share, Q1's and the layout
    copies' ms a step.  Before it, one int8 UNet eval at B with Q1's C
    entry wrapped: each launch must get the very tensor its conv module
    was given (no copy between the Block before and Q1), NCHW or
    channels_last."""
    out = {}
    cfg_q = dict(X2_CONFIG, conv_quant="int8")
    net_q, proc_q, init_q, _ = build_model(cfg_q)
    init_q(0)
    calibrate_conv_quant(cfg_q, net_q, proc_q, batch_size=4, n_points=4,
                         mode="noise")
    seen, passed = [], []
    hooks = [m.register_forward_pre_hook(lambda m, a: seen.append(
        (a[0].data_ptr(), a[0].is_contiguous())))
        for m in net_q.modules() if isinstance(m, Conv2d) and m.quant_sites]
    lib = qt._lib()

    class Recorder:
        def int8_conv(self, *a):
            passed.append(a[0].value)
            return lib.int8_conv(*a)

    with torch.no_grad(), mock.patch.object(qt, "_lib", lambda: Recorder()):
        proc_q.eps_fn(proc_q.init_latent(B, seed=3),
                      torch.full((B,), 500, device="cuda"))
    for h in hooks:
        h.remove()
    assert len(seen) == len(passed) == INT8_LAUNCHES, (len(seen), len(passed))
    assert [p for p, _ in seen] == passed, "a copy ran between a conv's input and Q1"
    nchw = sum(c for _, c in seen)
    log(f"  Q1 inputs: {nchw} of {len(seen)} launches of a UNet eval NCHW, the "
        f"rest channels_last; every launch read its conv's input in place")
    out["q1_inputs_nchw"] = [nchw, len(seen)]
    net_b, proc_b, init_b, _ = build_model(X2_CONFIG)
    init_b(0)
    out["profile"] = []
    for label in ("int8", "bf16", "int8"):
        proc = proc_q if label == "int8" else proc_b
        z = proc.init_latent(B_BULK, seed=11)
        ts = [900, 899]
        proc.p_sample_chain(z, ts, seed=11)
        prof = device_profile(lambda: proc.p_sample_chain(z, ts, seed=11), 2,
                              f"2 chain steps at B={B_BULK} ({label})")
        if prof is not None:
            by_cat, total, busy, idle = prof
            q1 = by_cat.get("Q1 int8_conv", 0.0) / 2e3
            copies = by_cat.get("layout copy", 0.0) / 2e3
            out["profile"].append({
                "label": label, "device_busy_ms": busy, "idle_share": idle,
                "q1_ms": q1, "q1_share": q1 * 2e3 / total, "layout_copy_ms": copies,
                "gemm_conv_ms": by_cat.get("gemm/conv", 0.0) / 2e3})
            log(f"  {label} at B={B_BULK}: device busy {busy:.2f} ms/step, idle "
                f"{idle:.3f}, Q1 {q1:.3f} ms/step ({q1 * 2e3 / total:.1%}), "
                f"layout copy {copies:.3f} ms/step")
        del z
        torch.cuda.empty_cache()
    del net_b, proc_b, net_q, proc_q
    torch.cuda.empty_cache()
    return out


def phase_int8(results):
    """The int8 serving mode: Q1 against its plain version and timed;
    generate_main --quant-conv int8 on phase 11's x2 checkpoint
    (trajectory calibration at batch 4, the chain cut to CHAIN_STEPS
    steps at B, the decode) with the counters zeroed; two profiled chain
    steps at B_BULK, int8 against bf16; one f32 quantized UNet eval on
    the card against the CPU's plain path on the same buffers; the
    subpixel transposed conv against F.conv_transpose2d."""
    log("phase 12: int8 serving (--quant-conv int8)")
    out = {"card": card_line(), "q1": phase_int8_kernel(results)}

    ckpt_x2 = os.path.join(EVAL_DIR, "x2_ddim")      # phase 11's
    T = X2_CONFIG["T"]
    cut = functools.partial(generate_samples, early_stop=T - CHAIN_STEPS)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    with mock.patch.object(generate_main, "generate_samples", cut):
        samples, latents, timing = generate_main.main(
            ["--checkpoint", ckpt_x2, "--quant-conv", "int8",
             "--quant-calib", "trajectory", "--quant-calib-batch", "4",
             "--fid-samples", str(B), "--batch-size", str(B),
             "--out", os.path.join(WORKDIR, "int8", "samples"),
             "--latent-out", os.path.join(WORKDIR, "int8", "samples_latent")])
    torch.cuda.synchronize()
    launched = counts()
    wall = time.time() - t0
    evals = INT8_CAL_EVALS + CHAIN_STEPS
    log(f"  generate --quant-conv int8: calibration (trajectory, batch 4, "
        f"{T} steps) and {CHAIN_STEPS} chain steps + decode at B={B}: "
        f"{wall:.2f} s in all, sampling {timing['total_s']:.3f} s "
        f"[{card_line()}]; launches {launched}")
    assert samples.shape == (1, B, 256, 256, 3), samples.shape
    assert latents.shape == (1, B, 128, 128, 8), latents.shape
    assert np.isfinite(samples).all() and np.isfinite(latents).all()
    assert samples.min() >= 0.0 and samples.max() <= 255.0
    want = {"int8_conv": INT8_LAUNCHES * evals,
            "attn_ctx": 5 * (T + evals), "attn_out": 5 * (T + evals),
            "convres_fwd": 3}
    assert {k: launched[k] for k in want} == want, (launched, want)
    assert not any(v for k, v in launched.items() if k not in want), launched
    results[("int8_conv", "x2_sample_int8")]["launches"] = launched["int8_conv"]
    out["generate"] = {"calibration": "trajectory, batch 4", "chain_steps": CHAIN_STEPS,
                       "batch": B, "wall_s": wall, "sampling_s": timing["total_s"],
                       "launches": {k: launched[k] for k in want}}

    out.update(phase_int8_profile())

    # one f32 quantized UNet eval on the card against the CPU's plain path,
    # the calibrated buffers of net_q on both
    cfg_q = dict(X2_CONFIG, conv_quant="int8")
    net_q, proc_q, init_q, _ = build_model(cfg_q)
    init_q(0)
    calibrate_conv_quant(cfg_q, net_q, proc_q, batch_size=4, n_points=4,
                         mode="noise")
    cfg32 = dict(cfg_q, compute_dtype="float32")
    net_g, proc_g, _, _ = build_model(cfg32)
    net_c, proc_c, _, _ = build_model(cfg32, device="cpu")
    state = {k: v.float().cpu() for k, v in net_q.state_dict().items()}
    net_g.load_state_dict(state)
    net_c.load_state_dict(state)
    del net_q, proc_q
    gen = torch.Generator().manual_seed(4)
    z = torch.randn((1, 128, 128, 8), generator=gen)
    t = torch.full((1,), 500, dtype=torch.int64)
    reset_counts()
    with torch.no_grad():
        eps_g = proc_g.eps_fn(z.cuda(), t.cuda()).cpu()
    assert counts()["int8_conv"] == INT8_LAUNCHES, counts()
    with torch.no_grad():
        eps_c = proc_c.eps_fn(z, t)
    scale = max(1.0, float(eps_c.abs().max()))
    err = float((eps_g - eps_c).abs().max())
    rel = float((eps_g - eps_c).norm() / eps_c.norm())
    log(f"  f32 quantized UNet, card against the CPU's plain path: max_abs_err "
        f"{err:.3e} (tol {1e-1 * scale:.3e}), relative L2 {rel:.3e} (tol 5e-2): "
        f"the float ops before each quantized conv round differently and the "
        f"flips cascade, as on the CPU against JAX (tests/test_torch_quant.py)")
    assert np.isfinite(err) and rel <= 5e-2 and err <= 1e-1 * scale
    out["card_vs_cpu_f32"] = {"max_abs_err": err, "relative_l2": rel}
    del net_g, net_c, proc_g, proc_c

    # the subpixel transposed conv against F.conv_transpose2d (the
    # Upsample's call), bf16 channels_last, at the x2 Upsamples' shapes
    out["subpixel"] = {}
    gen = torch.Generator(device="cuda").manual_seed(13)
    for bsz in (B, B_BULK):
        for hw, c in UPSAMPLES:
            r = lambda *sh: torch.randn(*sh, generator=gen, device="cuda")
            x = r(bsz, c, hw, hw).to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            w = (r(c, c, 4, 4) / (4 * c) ** 0.5).to(torch.bfloat16)
            b = (0.1 * r(c)).to(torch.bfloat16)
            ref = F.conv_transpose2d(x, w, b, 2, 1)
            err = check_close(f"subpixel B={bsz} {hw}^2 c{c}",
                              conv_transpose_2x_subpixel(x, w, b), ref,
                              torch.bfloat16)
            iters = 20 if bsz == B else 5
            sub_ms = cuda_ms(lambda: conv_transpose_2x_subpixel(x, w, b), iters, reps=3)
            ct_ms = cuda_ms(lambda: F.conv_transpose2d(x, w, b, 2, 1), iters, reps=3)
            out["subpixel"][f"B={bsz} {hw}^2 c{c}"] = {
                "subpixel_ms": sub_ms, "conv_transpose_ms": ct_ms,
                "max_abs_err": err}
            log(f"  Upsample B={bsz} {hw}^2 c{c}: subpixel {sub_ms:.3f} ms, "
                f"F.conv_transpose2d {ct_ms:.3f} ms")
            del x, ref
    torch.cuda.empty_cache()
    print(json.dumps({"int8_path": out}), flush=True)


# phase 13: the widths past the tuned kernels'.  (cm, cio) of K2/K3's
# width-general route (csrc/convres_general.cu) held against the plain
# versions: the ConvResNet blocks of d_chans 128, 192 and 256, cm 32 at a
# cio the tuned kernels do not take, and cm 96 with cio 160 (every N ends
# in a half-full 64-channel tile)
GENERAL_WIDTHS = [(64, 128), (96, 192), (128, 256), (32, 96), (96, 160)]
D128 = dict(c=128, cm=64)      # a d_chans 128 ConvResNet block
B_D128 = B_TRAIN               # the d_chans 128 train step's batch (32)
REC_D128 = 4                   # its recon rows per micro-batch (D128_T)
# t per micro-batch: 4 of 32 rows under t_rec_max = 100 in each
D128_T = [[3, 40, 77, 95] + [100 + 29 * i for i in range(28)],
          [57, 12, 5, 99] + [130 + 31 * i for i in range(28)]]
# the int8 unet_chan 160 model's quantized shape classes: the x2 UNet's,
# its channels x 160 / 128
INT8_CLASSES_160 = [(hw, c * 160 // 128, n1, n2) for hw, c, n1, n2 in INT8_CLASSES]
INT8_C160_STEPS = 3
PER[("convres_fwd_general", "x2_sample_d128")] = (
    f"x2 decode at B={B} with d_chans 128 (cm 64, cio 128): the upsampler's "
    f"three fused blocks, each timed alone at its shape")
PER[("convres_fwd_general", "x3_train_d128")] = (
    f"x3 train step at d_chans 128, B={B_D128} x accumulation 2, "
    f"{REC_D128} recon rows per micro-batch: 9 launches at the recon rows and "
    f"the downsampler's 4 at B={B_D128} per micro-batch, each timed alone")
PER[("convres_bwd_general", "x3_train_d128")] = (
    f"x3 train step at d_chans 128, B={B_D128} x accumulation 2, "
    f"{REC_D128} recon rows per micro-batch: 9 launches per micro-batch, "
    f"each timed alone")
PER[("int8_conv", "x2_sample_int8_c160")] = (
    f"x2 chain step at B={B} of an int8 unet_chan 160 model: "
    f"{INT8_LAUNCHES} launches (" + ", ".join(
        f"{n1 + 2 * n2} operands at {hw}^2 c{c}" for hw, c, n1, n2 in INT8_CLASSES_160)
    + "), on channels_last operands, each timed alone")


_CUDNN_MS: dict = {}


def cudnn_block_ms(bsz, hw, c, cm, backward: bool) -> float:
    """The yardstick beside K2 / K3 general (the port never calls it):
    cuDNN doing the block's convs alone at the same shapes, bf16,
    channels_last, timed eager like the kernel.  Forward: F.conv2d x4;
    backward: the three recompute convs (F.conv2d), the four data
    gradients (torch.nn.grad.conv2d_input) and the four weight gradients
    (torch.nn.grad.conv2d_weight)."""
    key = (bsz, hw, c, cm, backward)
    if key in _CUDNN_MS:
        return _CUDNN_MS[key]
    gen = torch.Generator(device="cuda").manual_seed(20)
    cl = torch.channels_last
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
    x = r(bsz, c, hw, hw).contiguous(memory_format=cl)
    m = r(bsz, cm, hw, hw).contiguous(memory_format=cl)
    ws = [r(cm, c, 1, 1), r(cm, cm, 3, 3), r(cm, cm, 3, 3), r(c, cm, 1, 1)]
    ws = [w.contiguous(memory_format=cl) for w in ws]
    pads = [0, 1, 1, 0]
    ins = [x, m, m, m]          # each conv's input
    outs = [m, m, m, x]         # its output (the gradient's shape)
    grad = torch.nn.grad

    def fwd():
        h = x
        for w, pad in zip(ws, pads):
            h = F.conv2d(h, w, padding=pad)
        return h

    def bwd():
        for w, pad, i in zip(ws[:3], pads, ins):
            F.conv2d(i, w, padding=pad)
        for w, pad, i, o in zip(ws, pads, ins, outs):
            grad.conv2d_input(i.shape, w, o, padding=pad)
            grad.conv2d_weight(i, w.shape, o, padding=pad)

    with torch.no_grad():
        ms = _CUDNN_MS[key] = cuda_ms(bwd if backward else fwd, 3)
    return ms


def general_case(cm, c, dtype, gen, scale, bsz=2, hw=128):
    """K2's general route against reference_impl at one width and
    scaling (residual), timed eager beside the plain version and its
    bound, and replayed from a CUDA graph (its kernels without the host's
    gaps); (ms, plain_ms, bound_ms, bound_by, err, cost, graph_ms)."""
    args = convres_inputs(hw, hw, dtype, gen, bsz=bsz, c=c, cm=cm)
    run = lambda: cr.fused_convres_block(*args, residual=True, scale=scale)
    plain = lambda: cr.reference_impl(*args, residual=True, scale=scale)
    with torch.no_grad():
        before = cr.LAUNCHES["convres_fwd_general"]
        got = run()
        assert cr.LAUNCHES["convres_fwd_general"] == before + 1
        err = check_close(f"K2 general cm {cm} cio {c} B={bsz} {hw}^2 scale={scale} "
                          f"{dtype}", got, plain(), dtype, quiet=True)
        ms, plain_ms = cuda_ms(run, 3), cuda_ms(plain, 3)
        gms = graph_ms(run, 3)
    cost = cr.cost(bsz, hw, hw, c, args[0].element_size(), scale, cm)
    bnd, by = bound_ms(cost, dtype)
    return ms, plain_ms, bnd, by, err, cost, gms


def general_bwd_case(cm, c, dtype, gen, bsz=2, hw=128):
    """K3's general route against backward_reference (residual), timed
    the same way; (ms, plain_ms, bound_ms, bound_by, err, cost, graph_ms)."""
    args = convres_inputs(hw, hw, dtype, gen, bsz=bsz, c=c, cm=cm)
    dy = torch.randn((bsz, hw, hw, c), generator=gen, device="cuda").to(dtype)
    before = cr.LAUNCHES["convres_bwd_general"]
    got = cr._bwd_kernel(*args, dy, True)
    assert cr.LAUNCHES["convres_bwd_general"] == before + 1
    want = cr.backward_reference(*args, dy, True)
    err = max(check_close(f"K3 general cm {cm} cio {c} B={bsz} {hw}^2 {name} {dtype}",
                          g, t, dtype, quiet=True)
              for name, g, t in zip(GRAD_NAMES, got, want))
    del got, want
    run = lambda: cr._bwd_kernel(*args, dy, True)
    ms = cuda_ms(run, 2)
    gms = graph_ms(run, 2)
    plain_ms = cuda_ms(lambda: cr.backward_reference(*args, dy, True), 2)
    cost = cr.cost_bwd(bsz, hw, hw, c, args[0].element_size(), cm)
    bnd, by = bound_ms(cost, dtype)
    return ms, plain_ms, bnd, by, err, cost, gms


def phase_general_kernels() -> dict:
    """K2 and K3's general route against their plain versions at
    GENERAL_WIDTHS, B = 2, 128^2 (K2: no scaling, 'up' and 'down'), bf16
    and f32, each timed eager beside the plain version and its bound;
    then two K3 launches at cm 128 give the same bits.  The route's
    ptxas lines first (no spill allowed)."""
    # bf16 on the tensor cores (conv1x1_mma, conv3x3_mma, wgrad1x1_mma,
    # wgrad3x3_mma), f32 on the FMA kernels (conv_gemm, conv_wgrad); none
    # spills
    ptxas_check("convres_general", "conv1x1_mma")
    names = [k["kernel"] for k in _build.ptxas_report("convres_general")]
    for kernel in ("conv3x3_mma", "wgrad1x1_mma", "wgrad3x3_mma", "conv_gemmIf",
                   "conv_wgradIf"):
        assert any(kernel in n for n in names), (kernel, names)
    gen = torch.Generator(device="cuda").manual_seed(16)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for cm, c in GENERAL_WIDTHS:
            for scale in (None, "up", "down"):
                ms, pms, bnd, by, err, _, gms = general_case(cm, c, dtype, gen, scale)
                lib = cudnn_block_ms(2, 128, c, cm, False)
                out[f"K2 cm{cm} cio{c} {scale} {dtype}"] = {
                    "ms": ms, "graph_ms": gms, "plain_ms": pms, "bound_ms": bnd,
                    "max_abs_err": err, "library_ms": lib}
                log(f"  K2 general cm {cm} cio {c} scale={scale} {dtype}: kernel "
                    f"{ms:.3f} ms ({gms:.3f} from a CUDA graph), plain {pms:.3f} ms, "
                    f"bound {bnd:.4f} ms ({by}, {bnd / gms:.1%}), cuDNN's 4 convs bf16 "
                    f"{lib:.3f} ms, max abs err {err:.3e}")
            ms, pms, bnd, by, err, _, gms = general_bwd_case(cm, c, dtype, gen)
            lib = cudnn_block_ms(2, 128, c, cm, True)
            out[f"K3 cm{cm} cio{c} {dtype}"] = {
                "ms": ms, "graph_ms": gms, "plain_ms": pms, "bound_ms": bnd,
                "max_abs_err": err, "library_ms": lib}
            log(f"  K3 general cm {cm} cio {c} {dtype}: kernel {ms:.3f} ms ({gms:.3f} "
                f"from a CUDA graph), plain {pms:.3f} ms, bound {bnd:.4f} ms ({by}, "
                f"{bnd / gms:.1%}), cuDNN's 11 convs bf16 {lib:.3f} ms; 9 gradients ok, "
                f"max abs err {err:.3e}")
            torch.cuda.empty_cache()
    args = convres_inputs(64, 64, torch.bfloat16, gen, bsz=2, c=256, cm=128)
    dy = torch.randn((2, 64, 64, 256), generator=gen, device="cuda").to(torch.bfloat16)
    first, second = cr._bwd_kernel(*args, dy, True), cr._bwd_kernel(*args, dy, True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    log("  K3 general at cm 128: two launches give the same bits")
    return out


def phase_d128_decode(results) -> dict:
    """The x2 sampling path with d_chans 128 (build_model ->
    generate_samples, the chain cut to 2 steps): the counters zeroed just
    before and read just after, K2's general route launched at each of the
    upsampler's three fused blocks (the tuned K2 never); K2 general timed
    at those shapes (B = 8) for the kernels line."""
    cfg = dict(X2_CONFIG, d_chans=128)
    net, process, init_fn, _ = build_model(cfg)
    init_fn(0)
    cut = cfg["T"] - 2
    generate_samples(process, seed=1, fid_samples=B, batch_size=B, early_stop=cut,
                     progress=False)   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    samples, latents, timing = generate_samples(
        process, seed=0, fid_samples=B, batch_size=B, early_stop=cut, progress=False)
    torch.cuda.synchronize()
    launched = counts()
    log(f"  d_chans 128 x2 sampling (2 chain steps + decode, B={B}): launches "
        f"{launched}, {timing['total_s']:.3f} s [{card_line()}]")
    assert samples.shape == (1, B, 256, 256, 3) and np.isfinite(samples).all()
    assert np.isfinite(latents).all()
    assert launched["convres_fwd_general"] == len(CONVRES_DECODE), launched
    assert launched["convres_fwd"] == launched["convres_bwd"] == 0, launched
    del net, process
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(17)
    for h, w, scale in sorted(set(CONVRES_DECODE)):
        n = CONVRES_DECODE.count((h, w, scale))
        ms, pms, bnd, by, err, cost, gms = general_case(
            D128["cm"], D128["c"], torch.bfloat16, gen, scale, bsz=B, hw=h)
        lib = cudnn_block_ms(B, h, D128["c"], D128["cm"], False)
        log(f"    K2 general {h}^2 scale={scale} B={B} bf16 (x{n} a decode): "
            f"kernel {ms:.3f} ms ({gms:.3f} from a CUDA graph), plain {pms:.3f} ms, "
            f"bound {bnd:.4f} ms ({by}), cuDNN's 4 convs {lib:.3f} ms")
        accumulate(results, "convres_fwd_general", "x2_sample_d128", n, ms, pms,
                   bnd, cost, err, library_ms=lib, graph_ms=gms)
    r = results[("convres_fwd_general", "x2_sample_d128")]
    r["launches"] = launched["convres_fwd_general"]
    log(f"  K2 general per d_chans 128 x2 decode (bf16): kernel {r['ms']:.3f} ms "
        f"({r['graph_ms']:.3f} from CUDA graphs), plain {r['plain_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.4f} ms, cuDNN's convs {r['library_ms']:.3f} ms")
    return {"launches": launched["convres_fwd_general"], "sampling_s": timing["total_s"],
            "k2_general_ms": r["ms"], "graph_ms": r["graph_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "library_ms": r["library_ms"]}


def phase_d128_train(results) -> dict:
    """One x3 train step at d_chans 128 (B = 32 x accumulation 2, bf16, 4
    recon rows per micro-batch, given t and eps) with remat off and then
    on, from the same weights, batch, t and eps: the counters zeroed just
    before and read just after each (K2's general route 13 launches and
    K3's 9 per micro-batch, the tuned kernels none), the losses equal
    within 1e-3 relative (the same kernels on the same inputs; remat only
    recomputes the UNet's ResnetBlocks in the backward, replaying the
    dropout masks), and each run's peak device memory, of the step and
    of the UNet's own forward and backward at the step's latent batch
    (what remat acts on).  Then K2 and K3's general route timed at the
    step's shapes for the kernels line."""
    out, metrics, state0 = {}, {}, None
    gen = torch.Generator().manual_seed(16)
    batch = (torch.rand((2, B_D128, 256, 256, 3), generator=gen) * 2 - 1).cuda()
    eps = torch.randn((2, B_D128, 32, 32, 8), generator=gen).cuda()
    t = torch.tensor(D128_T).cuda()
    assert all(sum(v < X3_CONFIG["t_rec_max"] for v in row) == REC_D128 for row in D128_T)
    for remat in (False, True):
        cfg = dict(X3_CONFIG, d_chans=128, batch_size=B_D128, remat=remat)
        net, proc, init_fn, _ = build_model(cfg)
        init_fn(0)
        if state0 is None:
            state0 = {k: v.clone() for k, v in net.state_dict().items()}
        net.load_state_dict(state0)
        net.train()
        state = create_train_state(net, create_optimizer(net, cfg["lr"]), seed=3)
        step = make_train_step(proc, 2, cfg["ema_decay"])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.time()
        m = step(state, batch, t=t, eps=eps)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launched = counts()
        peak = torch.cuda.max_memory_allocated()
        metrics[remat] = {k: float(v) for k, v in m.items()}
        log(f"  d_chans 128 x3 train step, remat {remat}: launches {launched}, "
            f"{wall:.2f} s (first step, set-up included), peak device memory "
            f"{peak / 2 ** 30:.3f} GiB, metrics {metrics[remat]} [{card_line()}]")
        want = {"convres_fwd_general": 2 * FWD_PER_MB,
                "convres_bwd_general": 2 * BWD_PER_MB, "attn_ctx": 2, "attn_out": 2}
        assert {k: launched[k] for k in want} == want, (launched, want)
        assert not any(v for k, v in launched.items() if k not in want), launched
        assert all(np.isfinite(v) for v in metrics[remat].values())
        # the UNet alone, forward and backward at the step's latent batch
        z = torch.rand((B_D128, 8, 32, 32), generator=gen).cuda() * 2 - 1
        tt = t[0]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.manual_seed(0)
        net.unet(z, tt).float().square().mean().backward()
        torch.cuda.synchronize()
        unet_peak = torch.cuda.max_memory_allocated() - base
        log(f"    the UNet's forward and backward alone (B={B_D128}, 32^2 latent), "
            f"remat {remat}: peak {unet_peak / 2 ** 30:.3f} GiB above the "
            f"{base / 2 ** 30:.3f} GiB held")
        out[f"remat_{remat}"] = {"peak_bytes": peak, "metrics": metrics[remat],
                                 "wall_s": wall, "unet_peak_bytes": unet_peak}
        del z
        if not remat:
            launches_d128 = {n: launched[n] for n in want}
        del net, proc, state, step
        torch.cuda.empty_cache()
    rel = {k: abs(metrics[True][k] - v) / max(abs(v), 1e-12)
           for k, v in metrics[False].items()}
    log(f"  remat on against off: relative differences {rel}; peak memory of "
        f"the step {out['remat_True']['peak_bytes'] / 2 ** 30:.3f} GiB against "
        f"{out['remat_False']['peak_bytes'] / 2 ** 30:.3f} GiB, of the UNet's "
        f"forward and backward {out['remat_True']['unet_peak_bytes'] / 2 ** 30:.3f} "
        f"GiB against {out['remat_False']['unet_peak_bytes'] / 2 ** 30:.3f} GiB")
    assert all(v <= 1e-3 for k, v in rel.items() if k != "grad_norm"), rel
    assert rel["grad_norm"] <= 1e-2, rel
    assert (out["remat_True"]["unet_peak_bytes"]
            < out["remat_False"]["unet_peak_bytes"]), out
    out["relative_differences"] = rel
    # the kernels line: K2 at the 9 recon-row blocks and the downsampler's
    # 4 at the full batch, K3 at the 9, per micro-batch, two micro-batches
    gen = torch.Generator(device="cuda").manual_seed(18)
    for bsz, blocks in ((REC_D128, TRAIN_BLOCKS), (B_D128, TRAIN_BLOCKS[:3])):
        for (h, w, scale), n in blocks:
            n = 2 if (bsz == B_D128 and scale is None) else n
            ms, pms, bnd, by, err, cost, gms = general_case(
                D128["cm"], D128["c"], torch.bfloat16, gen, scale, bsz=bsz, hw=h)
            lib = cudnn_block_ms(bsz, h, D128["c"], D128["cm"], False)
            log(f"    K2 general B={bsz} {h}^2 scale={scale} bf16: kernel {ms:.3f} ms "
                f"({gms:.3f} from a CUDA graph), plain {pms:.3f} ms, bound {bnd:.4f} "
                f"ms ({by}), cuDNN's 4 convs {lib:.3f} ms, {2 * n} launches a train step")
            accumulate(results, "convres_fwd_general", "x3_train_d128", 2 * n, ms,
                       pms, bnd, cost, err, library_ms=lib, graph_ms=gms)
    for (h, w, scale), n in TRAIN_BLOCKS:
        ms, pms, bnd, by, err, cost, gms = general_bwd_case(
            D128["cm"], D128["c"], torch.bfloat16, gen, bsz=REC_D128, hw=h)
        lib = cudnn_block_ms(REC_D128, h, D128["c"], D128["cm"], True)
        log(f"    K3 general B={REC_D128} {h}^2 ({scale}) bf16: kernel {ms:.3f} ms "
            f"({gms:.3f} from a CUDA graph), plain {pms:.3f} ms, bound {bnd:.4f} ms "
            f"({by}), cuDNN's 11 convs {lib:.3f} ms, {2 * n} launches a train step")
        accumulate(results, "convres_bwd_general", "x3_train_d128", 2 * n, ms, pms,
                   bnd, cost, err, library_ms=lib, graph_ms=gms)
    for name in ("convres_fwd_general", "convres_bwd_general"):
        r = results[(name, "x3_train_d128")]
        r["launches"] = launches_d128[name]
        log(f"  {name} per d_chans 128 x3 train step (bf16): kernel {r['ms']:.2f} ms "
            f"({r['graph_ms']:.2f} from CUDA graphs), plain {r['plain_ms']:.2f} ms, "
            f"bound {r['bound_ms']:.3f} ms, cuDNN's convs {r['library_ms']:.2f} ms")
        out[name] = {k: r[k] for k in ("ms", "graph_ms", "plain_ms", "bound_ms",
                                       "launches", "library_ms")}
    torch.cuda.empty_cache()
    return out


def phase_int8_c160(results) -> dict:
    """Q1 at the widths past 128 that JAX's gate quantizes: against its
    plain version, bit for bit, at C = 144 and 160 (B = 8, 32^2 and 13 x
    21), NCHW and channels_last, with and without the skip operand; then
    an int8 unet_chan 160 model (noise calibration at batch 4) runs
    INT8_C160_STEPS chain steps at B with the counters zeroed just before
    and read just after: Q1 launched at every quantized conv; Q1 timed at
    that model's shape classes for the kernels line."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    dt, out = torch.bfloat16, {}
    for c in (144, 160):
        for hw in (32, (13, 21)):
            h, w = (hw, hw) if isinstance(hw, int) else hw
            for skip in (False, True):
                args, kw, _ = int8_inputs(32, c, dt, gen, B, skip)
                if (h, w) != (32, 32):
                    args = (args[0][:, :, :h, :w].contiguous(
                        memory_format=torch.channels_last),) + args[1:]
                    if skip:
                        kw["skip"] = kw["skip"][:, :, :h, :w].contiguous(
                            memory_format=torch.channels_last)
                want = qt.plain(*args, **kw)
                for name, fmt in INT8_LAYOUTS:
                    a_, k_ = _as_layout(args, kw, fmt)
                    got = qt.int8_conv_q(*a_, **k_)
                    assert torch.equal(got, want), (c, h, w, skip, name)
                log(f"  Q1 C={c} {h}x{w} B={B} skip={skip}: equal to its plain "
                    f"version, NCHW and channels_last")
    cfg = dict(X2_CONFIG, unet_chan=160, conv_quant="int8")
    net, proc, init_fn, _ = build_model(cfg)
    init_fn(0)
    calibrate_conv_quant(cfg, net, proc, batch_size=4, n_points=4, mode="noise")
    sites = sum(1 for m in net.modules() if isinstance(m, Conv2d) and m.quant_sites)
    z = proc.init_latent(B, seed=5)
    ts = list(range(900, 900 - INT8_C160_STEPS, -1))
    proc.p_sample_chain(z, ts[:1], seed=5)
    torch.cuda.synchronize()
    reset_counts()
    z_out = proc.p_sample_chain(z, ts, seed=5)
    torch.cuda.synchronize()
    launched = counts()
    log(f"  int8 unet_chan 160: {sites} quantized convs, {INT8_C160_STEPS} chain "
        f"steps at B={B}: launches {launched}")
    assert sites == INT8_LAUNCHES, sites
    assert launched["int8_conv"] == INT8_LAUNCHES * INT8_C160_STEPS, launched
    assert torch.isfinite(z_out).all()
    del net, proc, z, z_out
    torch.cuda.empty_cache()
    for hw, c, n1, n2 in INT8_CLASSES_160:
        for skip, n in ((False, n1), (True, n2)):
            if not n:
                continue
            args, kw, _ = int8_inputs(hw, c, dt, gen, B, skip)
            want = qt.plain(*args, **kw)
            got = qt.int8_conv_q(*args, **kw)
            assert torch.equal(got, want), (hw, c, skip)
            ms = cuda_ms(lambda: qt.int8_conv_q(*args, **kw), 20, reps=3)
            pms = cuda_ms(lambda: qt.plain(*args, **kw), 2)
            cost = qt.cost(B, hw, hw, c, c, 2, operands=2 if skip else 1)
            bnd, by = bound_ms(cost, torch.int8)
            log(f"    Q1 {hw}^2 c{c}{' +skip' if skip else ''} B={B}: {ms * 1e3:.1f} "
                f"us (x{n} an eval), plain {pms * 1e3:.1f} us, bound {bnd * 1e3:.1f} "
                f"us ({by}, {bnd / ms:.1%})")
            accumulate(results, "int8_conv", "x2_sample_int8_c160", n, ms, pms, bnd,
                       cost, 0.0)
            del args, kw, want, got
    r = results[("int8_conv", "x2_sample_int8_c160")]
    r["launches"] = launched["int8_conv"]
    r["dtype"] = torch.int8
    out.update(q1_ms_per_eval=r["ms"], bound_ms=r["bound_ms"], sites=sites,
               launches=launched["int8_conv"])
    torch.cuda.empty_cache()
    return out


def phase_ragged_offpath() -> dict:
    """K4, K5 and K6 at one ragged width each (the wrappers pad), against
    their plain versions, bf16, B = 2, each timed beside the plain
    version: K5 at 40 -> 72 channels with the gn-fold + post_bias
    prologue, K6 at 24 -> 40 with mish, K4 at three heads of 20."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    dt, out = torch.bfloat16, {}
    x, w, b = r(2, 64, 64, 40).to(dt), r(3, 3, 40, 72) / 19, r(72)
    kw = {"scale": 1 + 0.1 * r(2, 40), "shift": 0.2 * r(2, 40),
          "post_bias": (0.1 * r(2, 40)).to(dt)}
    cases = {
        "K5 conv3x3 40->72": (lambda: c3.conv3x3_fused(x, w, b, **kw),
                              lambda: c3.plain(x, w, b, **kw), c3.LAUNCHES),
        "K6 winograd 24->40": (
            lambda: wg.conv3x3_winograd(x[..., :24].contiguous(), w[:, :, :24, :40],
                                        b[:40], apply_mish=True),
            lambda: wg.plain(x[..., :24].contiguous(), w[:, :, :24, :40], b[:40], True),
            wg.LAUNCHES)}
    q, k, v = (r(2, 1024, 60).to(dt) for _ in range(3))
    cases["K4 linear attention 3 heads of 20"] = (
        lambda: la.linear_attention(q, k, v, 20), lambda: la.plain(q, k, v, 20),
        la.LAUNCHES)
    for name, (kern, plain, counter) in cases.items():
        before = sum(counter.values())
        got = kern()
        assert sum(counter.values()) > before, name
        err = check_close(name, got, plain(), dt)
        ms, pms = cuda_ms(kern, 10), cuda_ms(plain, 10)
        out[name] = {"ms": ms, "plain_ms": pms, "max_abs_err": err}
        log(f"    {name}: kernel {ms:.4f} ms (the wrapper's padding included), "
            f"plain {pms:.4f} ms")
    return out


def phase_widths(results):
    """Phase 13: the widths past the tuned kernels' (see the module
    docstring)."""
    log("phase 13: widths")
    out = {"card": card_line(), "general_kernels": phase_general_kernels(),
           "d128_decode": phase_d128_decode(results),
           "d128_train": phase_d128_train(results),
           "int8_c160": phase_int8_c160(results),
           "ragged_offpath": phase_ragged_offpath()}
    print(json.dumps({"widths_path": out}), flush=True)


MULTIGPU_TIMEOUT_S = 600


def phase_multigpu():
    """Phase 14: the sharded paths on one NCCL rank per card, in a torchrun
    subprocess (see the module docstring); its failure fails the script."""
    n = torch.cuda.device_count()
    log(f"phase 14: multi-GPU, {n} rank(s) under NCCL")
    torch.cuda.empty_cache()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", "-m", "dddpm_tpu_torch.parallel.dryrun",
           "--full", "--workdir", os.path.join(WORKDIR, "multigpu")]
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=MULTIGPU_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)   # torchrun and its ranks
        proc.communicate()
        raise
    wall = time.time() - t0
    for line in stdout.splitlines():
        if not line.startswith('{"multigpu_path"'):
            log(f"  {line}")
    if proc.returncode:
        log(stderr[-8000:])
        raise RuntimeError(f"phase 14 exited {proc.returncode}")
    path = next(json.loads(line)["multigpu_path"] for line in stdout.splitlines()
                if line.startswith('{"multigpu_path"'))
    assert path["world_size"] == n and path["backend"] == "nccl", path
    for run in ("launches_replicated", "launches_fsdp"):
        launched = path["train"][run]
        assert all(launched[k] > 0 for k in ("attn_ctx", "attn_out",
                                             "convres_fwd", "convres_bwd")), (
            run, launched)
    assert path["checkpoint_round_trip"]["exact"], path
    if n == 1:
        assert path["train"]["replicated_vs_plain_max_abs"] == {
            "params": 0.0, "ema": 0.0}, path["train"]
        assert path["sampler"]["samples_max_abs"] == 0.0, path["sampler"]
    path["wall_s"] = wall
    log(f"  phase 14: {wall:.1f} s wall, the subprocess's start included")
    print(json.dumps({"multigpu_path": path}), flush=True)


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
    # the two-pass attention is the default path; phase_one_pass drives
    # the one-pass route itself, whatever DDDPM_ATTN_ONE_PASS says
    ab.FORCE_ONE_PASS = False

    t0 = time.time()
    _build.build_all(KERNELS)
    log(f"built {KERNELS} in {time.time() - t0:.1f} s")
    for name in KERNELS:
        log(f"--- ptxas {name} ---\n{_build.build_log(name).strip()}")

    results: dict = {}
    phase_attention(results)
    phase_attention_widths()
    phase_convres(results)
    phase_convres_bwd(results)
    net, process = phase_main_path(results)
    phase_profile(process)
    phase_against_cpu(net)
    phase_seam(results, net.unet)
    phase_winograd(results, net.unet)
    phase_linear_attention(results, net.unet)
    phase_one_pass(results, process)
    del net, process
    trainer = phase_train(results)
    ckpt_x3, seed_x3 = trainer.checkpoint_dir, trainer.state.seed
    del trainer
    torch.cuda.empty_cache()
    phase_train_against_cpu()
    phase_eval(ckpt_x3, seed_x3)
    phase_int8(results)
    phase_widths(results)
    phase_multigpu()
    phase_probes(results)
    log(f"chip_smoke: {time.time() - t0:.1f} s after the build started")

    # one entry per kernel and path: launches from that path's own zeroed
    # run, times and bound at that path's shapes, per what "per" says
    assert all(r["launches"] > 0 for r in results.values()), results
    kernels = [{
        "name": name, "path": path, "per": PER[(name, path)],
        "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": r["launches"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": ("bytes" if r["bytes"] / HBM_BYTES_PER_S
                     >= r["flops"] / PEAK_FLOPS[r.get("dtype", torch.bfloat16)]
                     else "operations"),
        "library_ms": r["library_ms"],
        **{k: r[k] for k in ("identity_ms", "graph_ms", "library_graph_ms",
                             "library_cl_ms", "two_pass_ms", "two_pass_graph_ms",
                             "shipped_ms")
           if k in r},
    } for (name, path), r in results.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
