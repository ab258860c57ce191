"""Bounded-memory image-batch streaming from npy/npz sample files (port
of dddpm_tpu/evaluation/io.py).

The 50k-sample artifacts are ~10 GB at 256^2.  One generator yields
(b, H, W, C) batches from

- an in-memory array (N, H, W, C) or (n_batches, B, H, W, C),
- a .npy file (memory-mapped, batches materialized one at a time),
- a .npz file (the member is decompressed as a stream: npy header parsed
  once, then fixed-size reads; the full array never exists in memory).
"""
from __future__ import annotations

import os
import zipfile
from typing import Iterator, Union

import numpy as np
from numpy.lib import format as npy_format


def _flatten_shape(shape):
    """(nb, B, H, W, C) -> total image count + image shape (H, W, C)."""
    if len(shape) == 5:
        return shape[0] * shape[1], tuple(shape[2:])
    if len(shape) == 4:
        return shape[0], tuple(shape[1:])
    raise ValueError(f"expected a 4-D or 5-D image array, got shape {shape}")


def _array_batches(arr: np.ndarray, batch_size: int) -> Iterator[np.ndarray]:
    n, img_shape = _flatten_shape(arr.shape)
    arr = arr.reshape((n,) + img_shape)
    for i in range(0, n, batch_size):
        yield np.asarray(arr[i:i + batch_size])


def _npz_member_batches(path: str, batch_size: int) -> Iterator[np.ndarray]:
    """Stream the first array member of an npz without materializing it."""
    with zipfile.ZipFile(path) as zf:
        names = [n for n in zf.namelist() if n.endswith(".npy")]
        if not names:
            raise ValueError(f"{path}: npz contains no arrays")
        # prefer the conventional default member name
        name = "arr_0.npy" if "arr_0.npy" in names else names[0]
        with zf.open(name) as f:
            version = npy_format.read_magic(f)
            shape, fortran, dtype = npy_format._read_array_header(f, version)
            if fortran or dtype.hasobject:
                # rare layouts: fall back to a full read
                yield from _array_batches(np.load(path)[name[:-4]], batch_size)
                return
            n, img_shape = _flatten_shape(shape)
            img_bytes = int(np.prod(img_shape)) * dtype.itemsize
            done = 0
            while done < n:
                b = min(batch_size, n - done)
                buf = f.read(b * img_bytes)
                if len(buf) != b * img_bytes:
                    raise IOError(f"{path}: truncated npz member {name}")
                yield np.frombuffer(buf, dtype).reshape((b,) + img_shape)
                done += b


def image_batch_stream(src: Union[np.ndarray, str, os.PathLike],
                       batch_size: int) -> Iterator[np.ndarray]:
    """Yield (<=batch_size, H, W, C) image batches from an array or file."""
    if isinstance(src, (str, os.PathLike)):
        path = os.fspath(src)
        if path.endswith(".npz"):
            yield from _npz_member_batches(path, batch_size)
        else:
            yield from _array_batches(np.load(path, mmap_mode="r"), batch_size)
    else:
        yield from _array_batches(np.asarray(src), batch_size)
