"""One-command real-data quality-parity runner (port of ``parity/run_parity.py``).

The public checkpoints and datasets are not in this repository, so the
quality-parity plan (BASELINE.md) is staged: the moment the inputs are at hand,
one command emits the zero-shot, classifier and detection rows of the BASELINE quality
table::

    python -m mammo_clip_tpu_torch.parity.run_parity \
        --checkpoint b5-model-best-epoch-7.tar \
        --vindr-csv  vindr_detection_v1_folds.csv --vindr-image-dir <pngs|shards> \
        --rsna-csv   rsna_folds.csv               --rsna-image-dir  <pngs|shards> \
        --det-csv    vindr_detection_v1_folds.csv [--det-image-dir <pngs|shards>] \
        [--ft] [--device cuda] --out parity_b5.json

Rows whose inputs are absent are skipped, so partial runs work. The RSNA CSV
also drives the classifier rows (``cli/classifier``, the reference README's
recipe, README.md:433-452: lp for ``--lp-epochs`` epochs, bs 8, lr 5e-5,
weighted BCE, fold ``--fold``; ``--ft`` adds the full finetune) unless
``--skip-lp``. The detection CSV drives the detection row (``cli/detector``
at ``--det-resize`` for ``--det-epochs`` epochs, batch ``--batch-size``; its
images from ``--det-image-dir``, else ``--vindr-image-dir``) unless
``--skip-det``.

Parity gate (BASELINE.json): |ours - reference| <= 0.5 AUROC points per row.
The ``expected`` slots ship as null; fill them from the MICCAI-2024 paper
tables (or a reference-repo rerun) when scoring; the script then prints the
gap per row and an overall PASS/FAIL.

Dry run (no data; a fake of the public .tar + synthetic images; the zero-shot
rows, the lp row and the detection row at 64x64, 1 epoch each):

    python -m mammo_clip_tpu_torch.parity.run_parity --selftest
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import io
import json
import os
import tempfile

import numpy as np

# Fill from the MICCAI-2024 paper or a reference rerun; None = not yet scored.
# Keys match the result rows below.
EXPECTED: dict = {
    "zs_vindr/mass": None,
    "zs_vindr/suspicious_calcification": None,
    "zs_rsna/malignancy": None,
    "lp_rsna/cancer": None,
    "ft_rsna/cancer": None,
    "det_vindr/mAP": None,
}
GATE = 0.005  # |ours - expected| <= 0.5 AUROC points (BASELINE.json)

def _capture_json_tail(fn, argv):
    """Run a CLI main() capturing stdout; return its last JSON line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    lines = [ln for ln in buf.getvalue().strip().splitlines() if ln.strip()]
    return json.loads(lines[-1])


def run(args) -> dict:
    from ..cli import classifier, detector, zeroshot

    results: dict = {}
    for name, csv_path, image_dir, split in (
            ("vindr", args.vindr_csv, args.vindr_image_dir, args.vindr_split),
            ("rsna", args.rsna_csv, args.rsna_image_dir, args.rsna_split)):
        if not csv_path:
            continue
        out = os.path.join(args.workdir, f"zs_{name}.json")
        zeroshot.main(["--checkpoint", args.checkpoint,
                       "--csv", csv_path, "--image-dir", image_dir,
                       "--dataset", name, "--split", split,
                       "--batch-size", str(args.batch_size), "--out", out,
                       "--device", args.device])
        with open(out) as f:
            for k, v in json.load(f).items():
                results[f"zs_{name}/{k}"] = v

    if args.rsna_csv and not args.skip_lp:
        for arch in ["lp"] + (["ft"] if args.ft else []):
            res = _capture_json_tail(classifier.main, [
                "--clip-checkpoint", args.checkpoint,
                "--csv", args.rsna_csv, "--image-dir", args.rsna_image_dir,
                "--label", "cancer", "--dataset", "rsna", "--arch", arch,
                "--epochs", str(args.lp_epochs), "--batch-size", str(args.batch_size),
                "--weighted-bce", "--fold", str(args.fold),
                "--workdir", os.path.join(args.workdir, f"clf_{arch}"),
                "--device", args.device])
            results[f"{arch}_rsna/cancer"] = res["best_metric"]

    if args.det_csv and not args.skip_det:
        res = _capture_json_tail(detector.main, [
            "--clip-checkpoint", args.checkpoint,
            "--csv", args.det_csv,
            "--image-dir", args.det_image_dir or args.vindr_image_dir,
            "--resize", str(args.det_resize), "--epochs", str(args.det_epochs),
            "--batch-size", str(args.batch_size),
            "--workdir", os.path.join(args.workdir, "det"),
            "--device", args.device])
        results["det_vindr/mAP"] = res["best_mAP"]
    return results


def report(results: dict) -> dict:
    rows = []
    ok = True
    print(f"\n{'row':34s} {'ours':>8s} {'expected':>9s} {'gap':>8s} {'gate':>6s}")
    for k, v in results.items():
        exp = EXPECTED.get(k)
        gap = None if exp is None else v - exp
        status = "—" if exp is None else ("PASS" if abs(gap) <= GATE else "FAIL")
        ok &= status != "FAIL"
        print(f"{k:34s} {v:8.4f} {('%9.4f' % exp) if exp is not None else '     null'} "
              f"{('%8.4f' % gap) if gap is not None else '       —'} {status:>6s}")
        rows.append({"row": k, "ours": v, "expected": exp, "gap": gap,
                     "status": status})
    scored = [r for r in rows if r["expected"] is not None]
    verdict = ("UNSCORED (fill parity.run_parity.EXPECTED from the paper)"
               if not scored else ("PASS" if ok else "FAIL"))
    print(f"parity verdict: {verdict}")
    return {"rows": rows, "gate_auc_points": GATE * 100, "verdict": verdict}


def _write_csv(path: str, rows) -> str:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return path


def _selftest(args, td: str) -> dict:
    """Dry-run the pipeline on a fake of the public .tar and synthetic
    images/CSVs: the command is one edit (real paths) away from producing the
    zero-shot, classifier and detection rows of the quality table."""
    from .fake_checkpoint import make_fake_public_tar

    ckpt = make_fake_public_tar(os.path.join(td, "b2-model-best-epoch-10.tar"),
                                variant="b2", image_hw=(128, 96))

    rng = np.random.default_rng(0)
    vindr = [{"patient_id": f"p{i}", "image_id": f"im{i}",
              "Mass": int(rng.integers(0, 2)),
              "Suspicious_Calcification": int(rng.integers(0, 2)),
              "split": "test"} for i in range(16)]
    vindr[0]["Mass"], vindr[1]["Mass"] = 0, 1
    vindr[0]["Suspicious_Calcification"] = 0
    vindr[1]["Suspicious_Calcification"] = 1
    rsna = [{"patient_id": f"p{i}", "image_id": f"im{i}", "laterality": "L",
             "cancer": int(i % 2), "fold": i % 3} for i in range(24)]
    det = []
    for i in range(12):
        x0, y0 = rng.integers(2, 30, 2)
        det.append({"study_id": f"s{i}", "image_id": f"im{i}",
                    "finding_categories": str(["Mass"]),
                    "resized_xmin": int(x0), "resized_ymin": int(y0),
                    "resized_xmax": int(x0 + 20), "resized_ymax": int(y0 + 20),
                    "split": "training" if i < 8 else "test"})

    args.checkpoint = ckpt
    args.vindr_csv = _write_csv(os.path.join(td, "vindr.csv"), vindr)
    args.vindr_image_dir, args.vindr_split = "synthetic://", "valid"
    args.rsna_csv = _write_csv(os.path.join(td, "rsna.csv"), rsna)
    args.rsna_image_dir, args.rsna_split = "synthetic://", "valid"
    args.det_csv = _write_csv(os.path.join(td, "det.csv"), det)
    args.det_image_dir = "synthetic://"
    args.lp_epochs, args.det_epochs, args.det_resize = 1, 1, 64
    args.batch_size = 4
    args.workdir = os.path.join(td, "run")
    os.makedirs(args.workdir, exist_ok=True)
    results = run(args)
    expected_rows = {"zs_vindr/mass", "zs_vindr/suspicious_calcification",
                     "zs_rsna/malignancy"}
    if not args.skip_lp:
        expected_rows |= {"lp_rsna/cancer"} | ({"ft_rsna/cancer"} if args.ft else set())
    if not args.skip_det:
        expected_rows.add("det_vindr/mAP")
    missing = expected_rows - set(results)
    if missing:
        raise RuntimeError(f"selftest did not produce rows: {missing}")
    if not all(np.isfinite(v) for v in results.values()):
        raise RuntimeError(f"selftest produced a non-finite metric: {results}")
    print("selftest OK: every parity row produced a finite metric")
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", help="reference .tar or the port's checkpoint dir")
    ap.add_argument("--vindr-csv")
    ap.add_argument("--vindr-image-dir")
    ap.add_argument("--vindr-split", default="test")
    ap.add_argument("--rsna-csv")
    ap.add_argument("--rsna-image-dir")
    ap.add_argument("--rsna-split", default="valid")
    ap.add_argument("--det-csv")
    ap.add_argument("--det-image-dir")
    ap.add_argument("--det-resize", type=int, default=512)
    ap.add_argument("--fold", type=int, default=0)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lp-epochs", type=int, default=30)
    ap.add_argument("--det-epochs", type=int, default=120)
    ap.add_argument("--ft", action="store_true", help="also run the full finetune arm")
    ap.add_argument("--skip-lp", action="store_true")
    ap.add_argument("--skip-det", action="store_true")
    ap.add_argument("--workdir", default="outputs/parity")
    ap.add_argument("--out", default=None)
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    if args.selftest:
        with tempfile.TemporaryDirectory(prefix="parity_selftest_") as td:
            results = _selftest(args, td)
    else:
        if not args.checkpoint:
            ap.error("--checkpoint is required (or use --selftest)")
        os.makedirs(args.workdir, exist_ok=True)
        results = run(args)
    payload = report(results)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
    return payload


if __name__ == "__main__":
    main()
