"""Input pipeline (port of dddpm_tpu/data/pipeline.py): batching,
transforms, train/val split, a background prefetch thread.

Loader iterates like the JAX package's (same shuffle and flip draws, same
float32 [-1, 1] or [0, 1] batches).  `raw()` yields the same batches
before the transform, as uint8 with their flip masks, so the trainer can
copy a quarter of the bytes to the card and transform there
(`to_float`).
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from dddpm_tpu_torch.data.datasets import load_dataset


def to_float(images: torch.Tensor, scale: float, bias: float,
             flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uint8 NHWC -> float32 images * scale + bias, each image whose flip
    entry is set mirrored left-right, on the images' device.  The affine
    map is a float64 table rounded once, as the JAX package's is."""
    lut = (torch.arange(256, dtype=torch.float64, device=images.device)
           * scale + bias).float()
    out = lut[images.long()]
    if flip is not None:
        out = torch.where(flip.to(out.device)[:, None, None, None],
                          out.flip(2), out)
    return out


class Loader:
    """Mini-batch iterator over an in-memory uint8 NHWC array.

    train transform = rescale to [-1, 1] (t * 2 - 1) + optional random
    horizontal flip; eval keeps [0, 1] (reference utils/data.py:77-96).
    """

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 rescale: bool = True, rnd_flip: bool = False, seed: int = 0):
        if images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError("images must be a uint8 NHWC array")
        self.images = images
        self.labels = labels
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rescale = rescale
        self.rnd_flip = rnd_flip
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        n = len(self.images) // self.batch_size
        if not self.drop_last and len(self.images) % self.batch_size:
            n += 1
        return n

    @property
    def scale_bias(self) -> Tuple[float, float]:
        """[0, 255] -> [0, 1], then optionally [-1, 1]."""
        return (2.0 / 255.0, -1.0) if self.rescale else (1.0 / 255.0, 0.0)

    def raw(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]]:
        """One epoch of (uint8 batch, flip mask or None, labels)."""
        order = np.arange(len(self.images))
        if self.shuffle:
            self._rng.shuffle(order)
        end = (len(order) // self.batch_size) * self.batch_size
        if not self.drop_last and end < len(order):
            end = len(order)
        for i in range(0, end, self.batch_size):
            idx = order[i:i + self.batch_size]
            flip = self._rng.rand(len(idx)) < 0.5 if self.rnd_flip else None
            yield self.images[idx], flip, self.labels[idx]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        scale, bias = self.scale_bias
        for images, flip, labels in self.raw():
            x = to_float(torch.from_numpy(images), scale, bias,
                         None if flip is None else torch.from_numpy(flip))
            yield x.numpy(), labels

    def cycle_raw(self):
        """Infinite epoch-reshuffling iterator over raw() (reference
        cycle())."""
        while True:
            yield from self.raw()


def prefetch(iterator: Iterator, size: int = 2) -> Iterator:
    """Background-thread prefetch: host batch prep overlaps device work."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()

    def producer():
        try:
            for item in iterator:
                q.put(item)
        finally:
            q.put(sentinel)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        yield item


def get_dataloader(config: dict, train: bool = True, data_root: str = "./data/",
                   val_split: float = 0.0, train_transform: bool = True,
                   seed: int = 0):
    """(train_loader, val_loader or None) when train, else the test
    loader (reference utils/data.py:103-201)."""
    images, labels = load_dataset(config, train, data_root)
    rescale = train_transform and config.get("model") in ("ddpm", "dddpm")
    rnd_flip = train_transform and bool(config.get("rnd_flip"))
    bs = config["batch_size"]
    if not train:
        return Loader(images, labels, bs, shuffle=False, drop_last=True,
                      rescale=rescale, rnd_flip=False, seed=seed)
    if val_split > 0:
        n = len(images)
        n_val = int(np.ceil(n * val_split))
        perm = np.random.RandomState(seed).permutation(n)
        val_idx, train_idx = perm[:n_val], perm[n_val:]
        train_loader = Loader(images[train_idx], labels[train_idx], bs,
                              shuffle=True, drop_last=True, rescale=rescale,
                              rnd_flip=rnd_flip, seed=seed)
        val_loader = Loader(images[val_idx], labels[val_idx], bs,
                            shuffle=False, drop_last=True, rescale=rescale,
                            rnd_flip=False, seed=seed)
        return train_loader, val_loader
    return Loader(images, labels, bs, shuffle=True, drop_last=True,
                  rescale=rescale, rnd_flip=rnd_flip, seed=seed), None
