"""Device rule of the port (counterpart of dddpm_tpu/utils/platform.py).

Entry points run on a CUDA card unless the caller names a device: the
first one, or cuda:LOCAL_RANK in a process of a process group (one
process per card, parallel/mesh.py).  With no card and no explicit
device they raise: nothing falls back to the CPU silently.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Union

import torch
import torch.distributed as dist

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` as a torch.device; None means 'cuda' (cuda:LOCAL_RANK
    under a process group), which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        if dist.is_available() and dist.is_initialized():
            return torch.device("cuda", int(os.environ.get(
                "LOCAL_RANK", torch.cuda.current_device())))
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """float32 matmuls and convs in full f32 (TF32 off for cuBLAS and
    cuDNN) inside the block, whatever the global flags say; the flags
    come back after.  (torch.backends.cudnn.flags would also switch
    cuDNN off unless told otherwise.)"""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
