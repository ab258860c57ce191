"""InceptionV3 feature extractor for FID / sFID / IS (port of
dddpm_tpu/evaluation/inception.py), NCHW inside.

The 2015 ``classify_image_graph_def`` topology, with three heads:

- ``pool3``: the 2048-d global average pool (FID);
- ``spatial``: the first 7 channels of the third 17x17 block's 1x1
  branch (``mixed_6/conv:0``), flattened in NHWC order (H, W, C), so it
  equals the JAX package's ``reshape(B, -1)`` element for element (sFID);
- ``softmax``: softmax(pool3 @ W) over 1008 classes, with no bias, as
  the reference's softmax graph builds it (IS).

The frozen graph's quirks are kept:

- the input is resized by legacy TF1 ResizeBilinear (source index = dst
  * in/out, no half-pixel centres; not F.interpolate) to 299x299 as two
  small matmuls, then mapped by (x - 128) * 0.0078125;
- SAME average pools exclude the padded cells (count_include_pad=False);
- the second 8x8 block pools with max, the first with the average.

BatchNorm is folded: every conv is kernel + bias + ReLU, so the npz of
real weights that scripts/export_inception_weights.py writes for the
JAX package loads here too (``load_params_npz``, keyed by flax param
paths, kernels HWIO).  Without weights the extractor draws its own
deterministic init from a torch generator: a different random net from
the JAX package's PRNGKey(42) net, which exercises the metric machinery
but gives no comparable FID.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dddpm_tpu_torch.parallel.mesh import (
    all_gather_rows,
    mesh_coords,
    shard_batch,
)
from dddpm_tpu_torch.utils.device import DeviceLike, full_f32, resolve_device

INCEPTION_SIZE = 299
N_CLASSES = 1008   # TF-slim inception class count (background included)
INIT_SEED = 42


class ConvBN(nn.Module):
    """Conv (folded BN: kernel + bias) + ReLU; 'SAME' is stride 1 here."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int],
                 stride: int = 1, padding: str = "SAME"):
        super().__init__()
        if padding == "SAME" and stride != 1:
            raise ValueError("SAME convs of this graph have stride 1")
        pad = (kernel[0] // 2, kernel[1] // 2) if padding == "SAME" else 0
        self.conv = nn.Conv2d(cin, cout, kernel, stride, pad)

    def forward(self, x):
        return F.relu(self.conv(x))


def _avg_pool_same(x):
    """3x3 stride-1 SAME average pool, padded cells excluded (TF AvgPool)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _max_pool_valid(x):
    return F.max_pool2d(x, 3, 2)


class MixedA(nn.Module):
    """35x35 block (mixed / mixed_1 / mixed_2)."""

    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvBN(cin, 64, (1, 1)),
            ConvBN(cin, 48, (1, 1)), ConvBN(48, 64, (5, 5)),
            ConvBN(cin, 64, (1, 1)), ConvBN(64, 96, (3, 3)),
            ConvBN(96, 96, (3, 3)),
            ConvBN(cin, pool_features, (1, 1))])

    def forward(self, x):
        c = self.convs
        return torch.cat([c[0](x), c[2](c[1](x)), c[5](c[4](c[3](x))),
                          c[6](_avg_pool_same(x))], dim=1)


class ReductionA(nn.Module):
    """35x35 -> 17x17 (Mixed_6a)."""

    def __init__(self, cin: int):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvBN(cin, 384, (3, 3), 2, "VALID"),
            ConvBN(cin, 64, (1, 1)), ConvBN(64, 96, (3, 3)),
            ConvBN(96, 96, (3, 3), 2, "VALID")])

    def forward(self, x):
        c = self.convs
        return torch.cat([c[0](x), c[3](c[2](c[1](x))), _max_pool_valid(x)],
                         dim=1)


class MixedB(nn.Module):
    """17x17 block with the 1x7 / 7x1 factorisation (mixed_4..mixed_7).
    Returns (concat, branch 0): the third block's branch 0 is the sFID
    tensor."""

    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvBN(cin, 192, (1, 1)),
            ConvBN(cin, c7, (1, 1)), ConvBN(c7, c7, (1, 7)),
            ConvBN(c7, 192, (7, 1)),
            ConvBN(cin, c7, (1, 1)), ConvBN(c7, c7, (7, 1)),
            ConvBN(c7, c7, (1, 7)), ConvBN(c7, c7, (7, 1)),
            ConvBN(c7, 192, (1, 7)),
            ConvBN(cin, 192, (1, 1))])

    def forward(self, x):
        c = self.convs
        b0 = c[0](x)
        b1 = c[3](c[2](c[1](x)))
        b2 = c[8](c[7](c[6](c[5](c[4](x)))))
        b3 = c[9](_avg_pool_same(x))
        return torch.cat([b0, b1, b2, b3], dim=1), b0


class ReductionB(nn.Module):
    """17x17 -> 8x8 (Mixed_7a)."""

    def __init__(self, cin: int):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvBN(cin, 192, (1, 1)), ConvBN(192, 320, (3, 3), 2, "VALID"),
            ConvBN(cin, 192, (1, 1)), ConvBN(192, 192, (1, 7)),
            ConvBN(192, 192, (7, 1)), ConvBN(192, 192, (3, 3), 2, "VALID")])

    def forward(self, x):
        c = self.convs
        return torch.cat([c[1](c[0](x)), c[5](c[4](c[3](c[2](x)))),
                          _max_pool_valid(x)], dim=1)


class MixedC(nn.Module):
    """8x8 block (mixed_9 / mixed_10); the second pools with max."""

    def __init__(self, cin: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool
        self.convs = nn.ModuleList([
            ConvBN(cin, 320, (1, 1)),
            ConvBN(cin, 384, (1, 1)), ConvBN(384, 384, (1, 3)),
            ConvBN(384, 384, (3, 1)),
            ConvBN(cin, 448, (1, 1)), ConvBN(448, 384, (3, 3)),
            ConvBN(384, 384, (1, 3)), ConvBN(384, 384, (3, 1)),
            ConvBN(cin, 192, (1, 1))])

    def forward(self, x):
        c = self.convs
        b1 = c[1](x)
        b2 = c[5](c[4](x))
        pooled = (F.max_pool2d(x, 3, 1, 1) if self.pool == "max"
                  else _avg_pool_same(x))
        return torch.cat([c[0](x), c[2](b1), c[3](b1), c[6](b2), c[7](b2),
                          c[8](pooled)], dim=1)


class InceptionV3(nn.Module):
    """The 2015 frozen graph's InceptionV3 trunk with the three heads."""

    spatial_channels = 7

    def __init__(self):
        super().__init__()
        self.stem = nn.ModuleList([
            ConvBN(3, 32, (3, 3), 2, "VALID"), ConvBN(32, 32, (3, 3), 1, "VALID"),
            ConvBN(32, 64, (3, 3)), ConvBN(64, 80, (1, 1), 1, "VALID"),
            ConvBN(80, 192, (3, 3), 1, "VALID")])
        self.mixed_a = nn.ModuleList([MixedA(192, 32), MixedA(256, 64),
                                      MixedA(288, 64)])
        self.reduction_a = ReductionA(288)
        self.mixed_b = nn.ModuleList([MixedB(768, c7)
                                      for c7 in (128, 160, 160, 192)])
        self.reduction_b = ReductionB(768)
        self.mixed_c = nn.ModuleList([MixedC(1280, "avg"), MixedC(2048, "max")])
        self.logits = nn.Linear(2048, N_CLASSES, bias=False)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        """x: (B, 3, 299, 299) preprocessed to (raw - 128) / 128."""
        s = self.stem
        x = s[2](s[1](s[0](x)))
        x = _max_pool_valid(x)
        x = s[4](s[3](x))
        x = _max_pool_valid(x)
        for blk in self.mixed_a:
            x = blk(x)
        x = self.reduction_a(x)
        for i, blk in enumerate(self.mixed_b):
            x, b0 = blk(x)
            if i == 2:   # mixed_6: its 1x1 branch is 'mixed_6/conv'
                sp = b0[:, :self.spatial_channels]
                spatial = sp.permute(0, 2, 3, 1).reshape(sp.shape[0], -1)
        x = self.reduction_b(x)
        for blk in self.mixed_c:
            x = blk(x)
        pool3 = x.mean(dim=(2, 3))
        return {"pool3": pool3, "spatial": spatial,
                "softmax": torch.softmax(self.logits(pool3), dim=-1)}


# --------------------------------------------------------- preprocessing

def tf1_bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) interpolation matrix reproducing TF1 ResizeBilinear with
    align_corners=False / half_pixel_centers=False: source coordinate =
    dst_index * (in/out), floor/ceil lerp, clamped at the top edge."""
    scale = in_size / out_size
    src = np.arange(out_size, dtype=np.float64) * scale
    lo = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float64)
    m = np.zeros((out_size, in_size), np.float64)
    m[np.arange(out_size), lo] += 1.0 - frac
    m[np.arange(out_size), hi] += frac
    return m.astype(np.float32)


def tf1_resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Legacy-TF1 bilinear resize of NCHW x by two interpolation matmuls."""
    h, w = x.shape[2:]
    if (h, w) == (out_h, out_w):
        return x
    mh = torch.from_numpy(tf1_bilinear_matrix(h, out_h)).to(x.device)
    mw = torch.from_numpy(tf1_bilinear_matrix(w, out_w)).to(x.device)
    return torch.matmul(torch.matmul(mh, x), mw.T)


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """NHWC [0, 255] images (uint8 or float; 1 channel repeated to 3) ->
    the graph's NCHW input: resize to 299^2, then (x - 128) / 128."""
    x = images.float().permute(0, 3, 1, 2)
    if x.shape[1] == 1:
        x = x.expand(-1, 3, -1, -1)
    x = tf1_resize_bilinear(x, INCEPTION_SIZE, INCEPTION_SIZE)
    return (x - 128.0) * 0.0078125


# ------------------------------------------------------- the weight bridge

def _blocks(model: InceptionV3) -> Iterator[Tuple[str, nn.Module]]:
    """(flax scope, module) of every ConvBN container, flax's auto-names
    (ClassName_index in call order)."""
    yield "", model
    for name, mods in (("MixedA", model.mixed_a),
                       ("ReductionA", [model.reduction_a]),
                       ("MixedB", model.mixed_b),
                       ("ReductionB", [model.reduction_b]),
                       ("MixedC", model.mixed_c)):
        for i, blk in enumerate(mods):
            yield f"{name}_{i}/", blk


def flax_params(model: InceptionV3) -> Dict[str, Tuple[torch.Tensor, str]]:
    """{flax param path: (the torch parameter, its layout)}, layout
    'hwio' (a conv kernel: flax HWIO, torch OIHW), 'io' (the Dense
    kernel: flax (2048, 1008), torch (1008, 2048)) or 'vector'."""
    out = {}
    for scope, blk in _blocks(model):
        convs = blk.stem if blk is model else blk.convs
        for j, cbn in enumerate(convs):
            key = f"params/{scope}ConvBN_{j}/Conv_0"
            out[key + "/bias"] = (cbn.conv.bias, "vector")
            out[key + "/kernel"] = (cbn.conv.weight, "hwio")
    out["params/Dense_0/kernel"] = (model.logits.weight, "io")
    return out


def _to_flax(t: torch.Tensor, layout: str) -> torch.Tensor:
    return {"hwio": lambda: t.permute(2, 3, 1, 0), "io": lambda: t.T,
            "vector": lambda: t}[layout]()


def _from_flax(a: np.ndarray, layout: str) -> np.ndarray:
    return {"hwio": lambda: a.transpose(3, 2, 0, 1), "io": lambda: a.T,
            "vector": lambda: a}[layout]()


def param_template_shapes(model: Optional[InceptionV3] = None
                          ) -> Dict[str, Tuple[int, ...]]:
    """{flax param path: flax shape} of the whole model."""
    model = InceptionV3() if model is None else model
    return {k: tuple(_to_flax(p, layout).shape)
            for k, (p, layout) in flax_params(model).items()}


@torch.no_grad()
def from_flax_entries(entries: Mapping[str, np.ndarray], model: InceptionV3,
                      allow_partial: bool = False,
                      source: str = "entries") -> InceptionV3:
    """Load {flax param path: array} into `model` (in place).

    Strict by default: raises ValueError listing model params absent
    from `entries`, entries that matched nothing, and any shape mismatch;
    a wrong weights file must never silently keep the random init.
    allow_partial=True loads whatever matches, unless a shape mismatches.
    """
    params = flax_params(model)
    names = set(entries.keys())
    missing, mismatched, loads = [], [], []
    for key, (p, layout) in params.items():
        if key not in names:
            missing.append(key)
            continue
        arr = np.asarray(entries[key])
        want = tuple(_to_flax(p, layout).shape)
        if arr.shape != want:
            mismatched.append(f"{key}: npz {arr.shape} != model {want}")
        else:
            loads.append((p, _from_flax(arr, layout)))
    unused = sorted(names - set(params))
    problems = []
    if mismatched:
        problems.append(f"{len(mismatched)} shape mismatches: "
                        + "; ".join(mismatched[:5]))
    if missing:
        problems.append(f"{len(missing)} model params not in npz: "
                        + ", ".join(missing[:5])
                        + ("..." if len(missing) > 5 else ""))
    if unused:
        problems.append(f"{len(unused)} npz arrays matched nothing: "
                        + ", ".join(unused[:5])
                        + ("..." if len(unused) > 5 else ""))
    if problems and not (allow_partial and not mismatched):
        raise ValueError(
            f"inception weights {source} do not match the model:\n  "
            + "\n  ".join(problems)
            + "\n(use allow_partial=True to load the matching subset)")
    for p, arr in loads:
        p.copy_(torch.from_numpy(np.ascontiguousarray(arr, np.float32)))
    return model


def load_params_npz(path: str, model: InceptionV3,
                    allow_partial: bool = False) -> InceptionV3:
    """Load folded-BN weights from an npz keyed by flax param paths like
    'params/MixedB_2/ConvBN_0/Conv_0/kernel' (HWIO kernels)."""
    with np.load(path) as data:
        return from_flax_entries({k: data[k] for k in data.files}, model,
                                 allow_partial, f"npz '{path}'")


@torch.no_grad()
def init_params_(model: InceptionV3, seed: int = INIT_SEED) -> InceptionV3:
    """Deterministic random init from a torch generator: kernels
    N(0, 1 / fan_in) (lecun normal), biases zero."""
    gen = torch.Generator().manual_seed(seed)
    for p, layout in flax_params(model).values():
        if layout == "vector":
            p.zero_()
        else:
            fan_in = p[0].numel()
            p.copy_(torch.randn(p.shape, generator=gen) / fan_in ** 0.5)
    return model


# ---------------------------------------------------------- the extractor

class FeatureExtractor:
    """Batched feature extraction from [0, 255] NHWC images.

    The forward runs in float32 with TF32 off (full_f32): with TF32 the
    card's activations drift from the CPU's by far more than f32
    rounding.  The tail batch runs at its own size (no padding).

    With `mesh` (a 1-D 'data' mesh from parallel.create_mesh) each batch
    is split over the ranks and every rank returns the one-process
    arrays (an all-gather of each head): batch_size is rounded up to a
    multiple of the mesh size, and a tail batch is zero-padded to one,
    the padding dropped after."""

    def __init__(self, weights_npz: Optional[str] = None, batch_size: int = 64,
                 device: DeviceLike = None, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        n = mesh_coords(mesh)[1]
        self.batch_size = -(-batch_size // n) * n
        self.model = init_params_(InceptionV3())
        self.has_real_weights = False
        weights_npz = weights_npz or os.environ.get("INCEPTION_WEIGHTS_NPZ")
        if weights_npz:
            if not os.path.exists(weights_npz):
                raise FileNotFoundError(
                    f"inception weights npz not found: {weights_npz}")
            load_params_npz(weights_npz, self.model)
            self.has_real_weights = True
        self.model = self.model.to(self.device).eval()

    @torch.no_grad()
    def features(self, images) -> Dict[str, torch.Tensor]:
        """The three heads of one NHWC batch (array or tensor), on the
        extractor's device."""
        arr = np.asarray(images)
        if not arr.flags.writeable:   # a memory map or a stream's buffer
            arr = arr.copy()
        x = torch.as_tensor(arr).to(self.device)
        with full_f32():
            return self.model(preprocess(x))

    def __call__(self, images) -> Dict[str, np.ndarray]:
        """images: (N, H, W, C) / (nb, B, H, W, C) float or uint8 in
        [0, 255], or a path to a .npy/.npz sample file (streamed in
        bounded memory, see evaluation/io.py)."""
        from dddpm_tpu_torch.evaluation.io import image_batch_stream

        outs = {"pool3": [], "spatial": [], "softmax": []}
        n = mesh_coords(self.mesh)[1]
        for batch in image_batch_stream(images, self.batch_size):
            count = len(batch)
            if count % n:
                batch = np.concatenate([batch, np.zeros(
                    (n - count % n,) + batch.shape[1:], batch.dtype)])
            res = self.features(shard_batch(batch, self.mesh))
            for k in outs:
                outs[k].append(all_gather_rows(res[k], self.mesh)[:count]
                               .cpu().numpy())
        return {k: np.concatenate(v) for k, v in outs.items()}
