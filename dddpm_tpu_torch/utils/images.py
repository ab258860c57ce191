"""Image grids (port of dddpm_tpu/utils/images.py), numpy + PIL."""
from __future__ import annotations

import numpy as np


def make_grid(batch: np.ndarray, nrow: int = 5, pad: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
    """Tile a (N, H, W, C) batch in [0, 1] into one (H', W', C) image."""
    n, h, w, c = batch.shape
    nrows = int(np.ceil(n / nrow))
    grid = np.full((nrows * (h + pad) + pad, nrow * (w + pad) + pad, c),
                   pad_value, dtype=np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        y, x = r * (h + pad) + pad, col * (w + pad) + pad
        grid[y:y + h, x:x + w] = batch[i]
    return grid


def save_image_grid(batch: np.ndarray, path: str, nrow: int = 5) -> str:
    """Save a [0, 1] NHWC batch as a tiled PNG."""
    from PIL import Image

    grid = make_grid(np.clip(batch, 0.0, 1.0), nrow=nrow)
    arr = (grid * 255.0).round().astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    Image.fromarray(arr).save(path)
    return path
