"""Evaluate a trained model (counterpart of evaluate_ddpm.py): the
test-set VLB and L_simple, and FID / sFID / IS / precision / recall of
saved samples against a reference batch, printed as one JSON object.

    python -m dddpm_tpu_torch.evaluate_main --checkpoint <dir> \
        --samples <npy> --reference <npy> [--data-root ./data/] \
        [--inception-weights npz | --allow-random-inception] \
        [--test-batches N | --skip-test-losses] [--device cpu]

The test losses take the weights generate_main takes (the EMA weights
when ema_decay > 0).  Runs on the CUDA card unless --device cpu.  Under
torchrun with more than one process the Inception pass is split over
the ranks (a mesh); the test-set VLB stays unsharded, as in the JAX
package: rank 0 runs it, after the Inception pass, and prints.
"""
import argparse
import json
import time

from dddpm_tpu_torch.data.pipeline import get_dataloader
from dddpm_tpu_torch.evaluation.evaluator import (
    Evaluator,
    require_inception_optin,
)
from dddpm_tpu_torch.evaluation.helpers import compute_test_losses
from dddpm_tpu_torch.generate_main import load_eval_model
from dddpm_tpu_torch.parallel.mesh import (
    create_mesh,
    initialize_distributed,
    is_main,
    world_size,
)
from dddpm_tpu_torch.utils import paths


def main(argv=None):
    """Prints the metrics JSON; returns (metrics, {"test_losses_s": wall
    seconds of the test losses, or None when skipped})."""
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--samples", required=True, help="samples npy path")
    p.add_argument("--reference", required=True, help="reference batch npy")
    p.add_argument("--data-root", default=paths.DATA_DIR, dest="data_root")
    p.add_argument("--inception-weights", default=None)
    p.add_argument("--test-batches", type=int, default=None,
                   help="cap test-loss batches (full T-step VLB is slow)")
    p.add_argument("--skip-test-losses", action="store_true")
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
                            args.allow_random_inception, "evaluate_main")
    initialize_distributed(device=args.device)

    # paths stream in bounded memory (npy mmap / npz chunked decompress);
    # over several processes the Inception pass is split over a mesh
    mesh = create_mesh() if world_size() > 1 else None
    evaluator = Evaluator(args.inception_weights, device=args.device,
                          mesh=mesh)
    sample_metrics = evaluator.evaluate(
        args.reference, args.samples,
        prec_recall_subset=args.prec_recall_subset)

    metrics, timing = {}, {"test_losses_s": None}
    if not is_main():
        return sample_metrics, timing
    if not args.skip_test_losses:
        _, process, config = load_eval_model(args.checkpoint, args.device)
        test_loader = get_dataloader(config, False, args.data_root)
        t0 = time.perf_counter()
        vlb, l_simple = compute_test_losses(process, 0, test_loader,
                                            args.test_batches)
        timing["test_losses_s"] = time.perf_counter() - t0
        metrics["vlb"] = vlb
        metrics["L_simple"] = l_simple
    metrics.update(sample_metrics)

    print(json.dumps(metrics, indent=2))
    return metrics, timing


if __name__ == "__main__":
    main()
