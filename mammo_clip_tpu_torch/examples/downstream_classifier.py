"""Tutorial: train a downstream classifier on top of a Mammo-CLIP checkpoint (the
port's twin of ``examples/downstream_classifier.py``; script form of the
reference's notebooks/Tutorial/Downstream_classifier_tutorial.ipynb): load the
CLIP checkpoint, build a frozen-encoder linear probe, train a few epochs,
report AUROC.

    python -m mammo_clip_tpu_torch.examples.downstream_classifier --checkpoint <ckpt> \\
        --csv folds.csv --image-dir <pngs|shards> [--epochs 1] [--device cuda]

Every other flag goes to ``cli/classifier`` as it is (``--device`` among them,
default ``cuda``).
"""

from __future__ import annotations

import argparse

from ..cli import classifier


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--checkpoint", required=True)
    args, rest = ap.parse_known_args(argv)
    return classifier.main(["--clip-checkpoint", args.checkpoint, "--arch", "lp", *rest])


if __name__ == "__main__":
    main()
