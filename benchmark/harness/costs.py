"""The yardstick of the kernels' rooflines, frozen here so that a change
to a kernel cannot move it: the H100's peaks, the least time of a
launch, the operations and bytes each kernel must do and move (copied
from the cost functions of dddpm_tpu_torch/ops/attention_block.py,
convres.py and quant.py as they stood when the benchmark was defined),
and the shapes at which a configuration launches each kernel.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# NVIDIA H100 SXM, dense: bf16 tensor cores, s8 tensor cores, HBM3
PEAK_BF16 = 989e12
PEAK_S8 = 1979e12
HBM_BYTES_PER_S = 3.35e12

HIDDEN, DIM_HEAD = 128, 32
# the attention block runs as K1a + K1b above this many tokens
ATTN_KERNEL_MIN_TOKENS = 513
# the fused ConvResBlock kernels' gate: at least 128^2 pixels, row tile 16
CONVRES_MIN_PIXELS, CONVRES_ROW_TILE = 128 * 128, 16


def least_s(cost: dict, peak: float = PEAK_BF16) -> float:
    """The least time of a launch: the larger of its bytes over HBM's
    rate and its operations over the peak."""
    return max(cost["bytes"] / HBM_BYTES_PER_S, cost["flops"] / peak)


def attention(bsz: int, n: int, c: int, itemsize: int) -> Dict[str, dict]:
    """K1a (attn_ctx) and K1b (attn_out)."""
    return {
        "attn_ctx": {
            "bytes": bsz * n * c * itemsize + c * 2 * HIDDEN * itemsize
            + bsz * HIDDEN * HIDDEN * 4,
            "flops": bsz * n * (2 * c * 2 * HIDDEN + 2 * HIDDEN * DIM_HEAD
                                + 8 * c),
        },
        "attn_out": {
            "bytes": 2 * bsz * n * c * itemsize + bsz * c * c * itemsize,
            "flops": bsz * n * (2 * c * c + 10 * c),
        },
    }


def convres_fwd(bsz: int, h: int, w: int, c: int, itemsize: int,
                scale: Optional[str], cm: int) -> dict:
    """K2: x read once, y written once, the weights; the four convs, mish
    counted as 8 operations."""
    pix = bsz * h * w
    out_pix = {None: pix, "up": 4 * pix, "down": pix // 4}[scale]
    weights = (2 * c * cm + 18 * cm * cm) * itemsize + (3 * cm + c) * 4
    return {
        "bytes": pix * c * itemsize + out_pix * c * itemsize + weights,
        "flops": pix * (2 * (2 * c * cm + 18 * cm * cm) + 8 * (c + 3 * cm)),
    }


def convres_bwd(bsz: int, h: int, w: int, c: int, itemsize: int,
                cm: int) -> dict:
    """K3: x and dy read, dx written, the weights read, eight float32
    gradients written; three convs recomputed, every data and weight
    gradient; mish, mish' and masks as 8 + 12 operations a channel."""
    pix = bsz * h * w
    conv = 2 * (2 * c * cm + 18 * cm * cm)
    n_w = 2 * c * cm + 18 * cm * cm + 3 * cm + c
    return {
        "bytes": 3 * pix * c * itemsize + (n_w - 3 * cm - c) * itemsize
        + 3 * cm * 4 + n_w * 4,
        "flops": pix * (3 * conv - 2 * c * cm + 20 * (c + 3 * cm)),
    }


def int8_conv(bsz: int, h: int, w: int, cin: int, cout: int, itemsize: int,
              operands: int = 1) -> dict:
    """Q1: each operand's x once, its s8 weights and scales, y once; 2 x 9
    x Cin x Cout s8 operations a pixel an operand."""
    pix = bsz * h * w
    return {"bytes": operands * (pix * cin * itemsize + 9 * cin * cout
                                 + cout * 4 + 4) + pix * cout * itemsize,
            "flops": operands * pix * 2 * 9 * cin * cout}


def attention_sites(config: dict) -> List[Tuple[int, int]]:
    """(tokens, channels) of each UNet attention block that runs as
    K1a + K1b, in the order of a forward pass."""
    size = config["image_size"] // 2 ** config["n_downsamples"]
    dims = [config["unet_chan"] * m for m in config["unet_dims"]]
    levels = len(dims)
    sites = [(size // 2 ** i, d) for i, d in enumerate(dims)]
    sites.append((size // 2 ** (levels - 1), dims[-1]))
    for i in range(levels - 2, -1, -1):
        sites.append((size // 2 ** (i + 1), dims[i]))
    return [(s * s, c) for s, c in sites if s * s >= ATTN_KERNEL_MIN_TOKENS]


def convres_sites(config: dict, up: bool) -> List[Tuple[int, int, Optional[str]]]:
    """(height, width, scale) of each ConvResBlock of the downsampler (or
    the upsampler) that runs as K2 (forward) / K3 (backward): the blocks
    whose input passes the fused kernels' gate."""
    d, mid = config["d_chans"], config["d_chans"] // 2
    side = config["image_size"]
    n, blocks = config["n_downsamples"], config["u_n_blocks" if up else "d_n_blocks"]
    if up:
        side //= 2 ** n
    out = []
    for _ in range(n):
        scale = "up" if up else "down"
        for j in range(blocks):
            s = scale if j == 0 else None
            th = min(CONVRES_ROW_TILE, side)
            if ((4 * d) % 128 == 0 and (4 * mid) % 128 == 0 and side % 4 == 0
                    and side % th == 0 and side * side >= CONVRES_MIN_PIXELS
                    and not (s == "down" and (side % 8 or th % 2))):
                out.append((side, side, s))
            if j == 0:
                side = side * 2 if up else side // 2
    return out


def int8_sites(config: dict) -> List[Tuple[int, int, int, int, int]]:
    """(height, width, channels an operand, out channels, operands) of
    each conv the int8 mode runs as Q1, in a forward pass of the UNet
    (the reference's gate, traced on the meta device)."""
    import torch
    from benchmark.reference.model import DDDPMNet, mark_int8, set_mode

    net = DDDPMNet(config).to("meta")
    gated = mark_int8(net)
    set_mode(gated, "off")
    sites = []

    def hook(conv, args):
        ops = [a for a in args if a is not None]
        sites.append((ops[0].shape[2], ops[0].shape[3], ops[0].shape[1],
                      conv.weight.shape[0], len(ops)))
    for conv in gated:
        conv.register_forward_pre_hook(hook)
    zs = config["image_size"] // 2 ** config["n_downsamples"]
    with torch.no_grad():
        net.unet(torch.empty(1, config["unet_in"], zs, zs, device="meta"),
                 torch.zeros(1, dtype=torch.int64, device="meta"))
    return sites
