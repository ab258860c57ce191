"""Dataset readers (port of dddpm_tpu/data/datasets.py), numpy and PIL.

Decodes the on-disk formats torchvision uses (MNIST idx(.gz), CIFAR
pickles, class-subdirectory image folders) and a deterministic
'synthetic' set, once, into an in-memory uint8 NHWC array (resize and
center crop applied at load).  Per-batch transforms happen in the
loader, or on the card in the trainer.
"""
from __future__ import annotations

import glob
import gzip
import os
import pickle
from typing import List, Tuple

import numpy as np

DATASETS = [
    "cifar10", "cifar100", "mnist", "omniglot",
    "celeba", "celeba_hq_64", "celeba_hq", "synthetic",
]


def _resize_center_crop(img: "np.ndarray", size: int) -> np.ndarray:
    """torchvision Resize(size) (smaller edge, bilinear) + CenterCrop(size)."""
    from PIL import Image

    pil = Image.fromarray(img)
    w, h = pil.size
    short = min(w, h)
    new_w, new_h = round(w * size / short), round(h * size / short)
    pil = pil.resize((new_w, new_h), Image.BILINEAR)
    left = (new_w - size) // 2
    top = (new_h - size) // 2
    pil = pil.crop((left, top, left + size, top + size))
    out = np.asarray(pil)
    if out.ndim == 2:
        out = out[..., None]
    return out


def _maybe_open(path: str):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(path)


def _read_idx(path: str) -> np.ndarray:
    """Read an IDX-format file (MNIST)."""
    with _maybe_open(path) as f:
        data = f.read()
    magic = int.from_bytes(data[0:4], "big")
    ndim = magic & 0xFF
    dims = [int.from_bytes(data[4 + i * 4: 8 + i * 4], "big") for i in range(ndim)]
    return np.frombuffer(data, np.uint8, offset=4 + 4 * ndim).reshape(dims)


def load_mnist(root: str, train: bool) -> Tuple[np.ndarray, np.ndarray]:
    base = os.path.join(root, "MNIST", "raw")
    prefix = "train" if train else "t10k"
    images = _read_idx(os.path.join(base, f"{prefix}-images-idx3-ubyte"))
    labels = _read_idx(os.path.join(base, f"{prefix}-labels-idx1-ubyte"))
    return images[..., None], labels.astype(np.int64)


def load_cifar(root: str, train: bool, fine: bool = False,
               hundred: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    if hundred:
        files = ["train"] if train else ["test"]
        base = os.path.join(root, "cifar-100-python")
        label_key = b"fine_labels"
    else:
        files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        base = os.path.join(root, "cifar-10-batches-py")
        label_key = b"labels"
    xs, ys = [], []
    for name in files:
        with open(os.path.join(base, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(d[b"data"])
        ys.extend(d[label_key])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x), np.asarray(ys, np.int64)


def load_image_folder(folder: str, image_size: int, channels: int = 3,
                      extensions=("jpg", "jpeg", "png")) -> Tuple[np.ndarray, np.ndarray]:
    """DatasetFolder-style loader: class subdirectories of images.

    Images are found recursively below each class directory (omniglot
    nests alphabet/character/*.png).  ``channels`` selects the PIL
    conversion: 1 -> grayscale 'L' (omniglot, reference torchvision
    Omniglot yields 1-channel), 3 -> 'RGB' (celeba*)."""
    from PIL import Image

    classes = sorted(
        d for d in os.listdir(folder) if os.path.isdir(os.path.join(folder, d))
    )
    paths: List[Tuple[str, int]] = []
    for ci, cls in enumerate(classes):
        for ext in extensions:
            pattern = os.path.join(folder, cls, "**", f"*.{ext}")
            for p in sorted(glob.glob(pattern, recursive=True)):
                paths.append((p, ci))
    if not paths:
        raise FileNotFoundError(f"no images under {folder}")
    mode = "L" if channels == 1 else "RGB"
    imgs = np.empty((len(paths), image_size, image_size, channels), np.uint8)
    labels = np.empty((len(paths),), np.int64)
    for i, (p, ci) in enumerate(paths):
        img = np.asarray(Image.open(p).convert(mode))
        imgs[i] = _resize_center_crop(img, image_size)
        labels[i] = ci
    return imgs, labels


def make_synthetic(image_size: int, channels: int = 3, n: int = 512,
                   seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic structured images (gradients + blobs) for tests/bench."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:image_size, 0:image_size] / max(image_size - 1, 1)
    imgs = np.empty((n, image_size, image_size, channels), np.uint8)
    for i in range(n):
        cx, cy = rng.rand(2)
        r = 0.1 + 0.3 * rng.rand()
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r * r)))
        base = 0.5 * xx[None] + 0.5 * yy[None]
        img = np.stack([
            np.clip(base[0] * rng.rand() + blob * rng.rand(), 0, 1)
            for _ in range(channels)
        ], axis=-1)
        imgs[i] = (img * 255).astype(np.uint8)
    labels = rng.randint(0, 2, size=n).astype(np.int64)
    return imgs, labels


LABEL_MAPS = {
    "cifar10": ["airplane", "automobile", "bird", "cat", "deer", "dog",
                "frog", "horse", "ship", "truck"],
    "mnist": [str(i) for i in range(10)],
    "celeba": ["female", "male"],
    "celeba_hq": ["female", "male"],
    "celeba_hq_64": ["female", "male"],
    "synthetic": ["a", "b"],
}


def get_label_map(dataset: str) -> List[str]:
    """The class names of a dataset's labels; raises for a dataset with
    none (cifar100's come from the dataset's own meta file)."""
    if dataset == "cifar100":
        raise ValueError("cifar100 label names come from the dataset's "
                         "meta file; read cifar-100-python/meta")
    if dataset not in LABEL_MAPS:
        raise ValueError(f"Dataset {dataset} has no label map")
    return LABEL_MAPS[dataset]


def get_color_channels(dataset: str) -> int:
    if dataset in ("cifar10", "cifar100", "celeba", "celeba_hq",
                   "celeba_hq_64", "synthetic"):
        return 3
    if dataset in ("mnist", "omniglot"):
        return 1
    raise ValueError(f"Dataset {dataset} does not have a color channel set")


def load_dataset(config: dict, train: bool, data_root: str
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Load raw uint8 NHWC images + labels, resized/cropped to image_size."""
    name = config["dataset"]
    size = config["image_size"]
    if name == "mnist":
        imgs, labels = load_mnist(data_root, train)
    elif name == "cifar10":
        imgs, labels = load_cifar(data_root, train)
    elif name == "cifar100":
        imgs, labels = load_cifar(data_root, train, hundred=True)
    elif name == "omniglot":
        split = "images_background" if train else "images_evaluation"
        return load_image_folder(
            os.path.join(data_root, "omniglot-py", split), size,
            channels=get_color_channels("omniglot"))
    elif name in ("celeba", "celeba_hq", "celeba_hq_64"):
        split = "train" if train else "test"
        return load_image_folder(os.path.join(data_root, name, split), size)
    elif name == "synthetic":
        return make_synthetic(size, 3, seed=0 if train else 1)
    else:
        raise ValueError(f"Dataset {name} not implemented")

    if imgs.shape[1] != size or imgs.shape[2] != size:
        out = np.empty((len(imgs), size, size, imgs.shape[-1]), np.uint8)
        for i in range(len(imgs)):
            out[i] = _resize_center_crop(imgs[i].squeeze(-1)
                                         if imgs.shape[-1] == 1 else imgs[i], size)
        imgs = out
    return imgs, labels
