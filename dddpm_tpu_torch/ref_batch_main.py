"""Dump a reference batch of real images for FID (counterpart of
create_ref_batch.py): training images with the eval transform (no [-1,
1] rescale), as a (n_batches, B, H, W, C) x255 NHWC float32 npy.

    python -m dddpm_tpu_torch.ref_batch_main -d cifar10 -is 32 \
        [--n 50000] [--bs 100] [--out results/reference]
"""
import argparse
import os

import numpy as np

from dddpm_tpu_torch.data.pipeline import get_dataloader
from dddpm_tpu_torch.utils import paths


def main(argv=None):
    """Saves the batch; returns its path."""
    p = argparse.ArgumentParser()
    p.add_argument("-d", default="cifar10", dest="dataset")
    p.add_argument("-is", type=int, default=32, dest="image_size")
    p.add_argument("--n", type=int, default=50000)
    p.add_argument("--bs", type=int, default=100)
    p.add_argument("--data-root", default=paths.DATA_DIR, dest="data_root")
    p.add_argument("--out", default=paths.REFERENCE_DIR)
    args = p.parse_args(argv)

    config = {"dataset": args.dataset, "image_size": args.image_size,
              "batch_size": args.bs, "rnd_flip": False}
    loader, _ = get_dataloader(config, True, args.data_root,
                               train_transform=False)

    batches, total = [], 0
    for x, _ in loader:
        batches.append(x * 255.0)  # the eval transform keeps [0, 1]
        total += len(x)
        if total >= args.n:
            break

    out = np.stack(batches)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.dataset}_{total}")
    np.save(path, out, allow_pickle=False)
    print(f"Saved reference batch {out.shape} to {path}.npy")
    return path + ".npy"


if __name__ == "__main__":
    main()
