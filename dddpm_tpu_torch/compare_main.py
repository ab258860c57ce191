"""FID / sFID / IS / precision / recall between two saved npy image
batches (counterpart of compare_datasets.py: the real-vs-real sanity
check), printed as one JSON object.

    python -m dddpm_tpu_torch.compare_main --batch1 a.npy --batch2 b.npy \
        [--inception-weights npz | --allow-random-inception] [--device cpu]

Under torchrun with more than one process the Inception pass is split
over the ranks (a mesh); rank 0 prints.
"""
import argparse
import json

import numpy as np

from dddpm_tpu_torch.evaluation.evaluator import (
    Evaluator,
    require_inception_optin,
)
from dddpm_tpu_torch.parallel.mesh import (
    create_mesh,
    initialize_distributed,
    is_main,
    world_size,
)


def main(argv=None):
    """Prints the metrics JSON and returns it."""
    p = argparse.ArgumentParser()
    p.add_argument("--batch1", required=True)
    p.add_argument("--batch2", required=True)
    p.add_argument("--inception-weights", default=None)
    p.add_argument("--prec-recall-subset", type=int, default=None,
                   help="subsample the P/R manifold estimate to N features "
                        "(default: full set, matching the reference)")
    p.add_argument("--allow-random-inception", action="store_true",
                   help="compute FID/IS/P/R through a random-init Inception "
                        "(machinery check only; numbers are NOT comparable)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain PyTorch path)")
    args = p.parse_args(argv)
    require_inception_optin(args.inception_weights,
                            args.allow_random_inception, "compare_main")

    initialize_distributed(device=args.device)

    b1 = np.load(args.batch1, mmap_mode="r")
    b2 = np.load(args.batch2, mmap_mode="r")
    mesh = create_mesh() if world_size() > 1 else None
    evaluator = Evaluator(args.inception_weights, device=args.device,
                          mesh=mesh)
    metrics = evaluator.evaluate(b1, b2,
                                 prec_recall_subset=args.prec_recall_subset)
    if is_main():
        print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
