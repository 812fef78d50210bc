"""Serving-export CLI: checkpoint -> self-contained ``torch.export`` artifacts
(port of ``mammo_clip_tpu/cli/export.py``).

Loads a trained checkpoint (a port checkpoint directory or a reference ``.tar``)
through the path every evaluator uses (``eval/loading.load_clip_for_eval``: the
checkpoint embeds its config), then saves the image and text embedders with
their parameters held in the programs (``utils/export.py``). The output
directory is everything a serving process needs: ``image_fn.<device>.pt2``,
``text_fn.<device>.pt2`` and ``serving.json``; no model code, checkpoint or
config at serving time.

    python -m mammo_clip_tpu_torch.cli.export --checkpoint outputs/b5/best \\
        --out serving/b5 [--batch 8] [--image-size H W] [--text-len 256] [--device cuda]

Where the port's contract differs from JAX's: one ``.pt2`` per device (the
``--device`` the model is loaded and traced on, default ``cuda``) in place of
one StableHLO artifact for several platforms; ``serving.json``'s ``requires``
names the modules a loader imports first (the flash-attention operator's, for a
ViT traced on a card); an fp32 artifact runs under full fp32 (TF32 off) in
``ServingModule``. The JAX CLI's compile cache (``utils/cache.py``) has no
counterpart: eager PyTorch compiles nothing.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True,
                    help="port checkpoint dir (run dir or step root) or reference .tar")
    ap.add_argument("--out", required=True, help="output artifact directory")
    ap.add_argument("--batch", type=int, default=8,
                    help="serving batch size fixed in the artifact shapes")
    ap.add_argument("--image-size", type=int, nargs=2, default=None, metavar=("H", "W"),
                    help="override the checkpoint config's image size")
    ap.add_argument("--text-len", type=int, default=None,
                    help="override the checkpoint config's text length")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from ..eval.loading import load_clip_for_eval
    from ..utils.export import export_clip_serving

    model, cfg = load_clip_for_eval(args.checkpoint, device=args.device)
    h, w = args.image_size or (cfg.data.image_size_h, cfg.data.image_size_w)
    text_len = args.text_len or cfg.data.text_max_length
    files = export_clip_serving(model, (h, w), text_len, batch=args.batch, out_dir=args.out)
    result = {"exported": files, "image_size": [h, w], "text_len": text_len,
              "batch": args.batch}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
