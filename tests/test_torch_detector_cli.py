"""The port's detector entry point on the CPU (``--device cpu``): ``cli/detector``.

* from a tiny port CLIP checkpoint (b0 at 64x64, fused route on, so the
  eval-mode backbone takes the fused route's unfused blocks): 1 epoch, then
  ``--resume`` to 2; the JSON line, the per-epoch lines, the resume
  checkpoint's epoch and ``best_mAP``, and ``best/`` with ``arrays.npz``
  holding one slate per validation image;
* fault R8: a validation split of 6 images at batch 4 is scored on all 6
  here, and on 4 (6 - 6 % 4) by the JAX CLI's full-batch loop;
* ``build_detection_table`` equal to the JAX CLI's on the same CSV (pandas
  there, the port's ``Table`` here; a category outside the classes dropped);
* multi-scale soft-NMS evaluation with a frozen backbone: the backbone in the
  resume checkpoint is the CLIP checkpoint's, bit for bit.

The parity runner's dry run with the detection row is in
``test_torch_eval_cli.py::test_parity_dry_run``.
"""

import csv
import json
import math

import numpy as np
import pytest
import torch

from mammo_clip_tpu.cli import detector as jax_detector_cli
from mammo_clip_tpu.data.metadata import load_metadata as jax_load_metadata
from mammo_clip_tpu.data.metadata import split_dataframe as jax_split
from mammo_clip_tpu_torch.cli import detector
from mammo_clip_tpu_torch.core.config import tiny_test_config
from mammo_clip_tpu_torch.data.images import SyntheticImageStore
from mammo_clip_tpu_torch.data.metadata import load_metadata, split_dataframe
from mammo_clip_tpu_torch.downstream.detect import VINDR_DETECTION_CLASSES
from mammo_clip_tpu_torch.models import build_model
from mammo_clip_tpu_torch.train import build_optimizer, create_train_state
from mammo_clip_tpu_torch.train.checkpoint import load_checkpoint_arrays, save_checkpoint

BATCH = 4
N_VALID = 6  # 6 % 4 = 2 images past the last full batch


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """1 intra-op thread: the suite runs its files in parallel
    processes, and torch's default of one thread per core in each oversubscribes
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rows():
    """VinDr-style box rows: 8 training images (one with two boxes, one row of a
    category outside the classes), N_VALID test images."""
    rng = np.random.default_rng(0)
    rows = []
    for i in range(8 + N_VALID):
        x0, y0 = (int(v) for v in rng.integers(2, 30, 2))
        split = "training" if i < 8 else "test"
        cats = ["Mass"] if i % 3 else ["Suspicious Calcification", "Mass"]
        rows.append({"study_id": f"s{i}", "image_id": f"im{i}", "finding_categories": str(cats),
                     "resized_xmin": x0, "resized_ymin": y0, "resized_xmax": x0 + 20,
                     "resized_ymax": y0 + 24, "split": split})
    rows.append(dict(rows[1], resized_xmin=40, resized_xmax=60))  # a second box on im1
    rows.append(dict(rows[2], finding_categories=str(["Unknown"])))  # not a class
    return rows


@pytest.fixture(scope="module")
def clip_ckpt(tmp_path_factory):
    cfg = tiny_test_config()
    cfg.model.image_encoder.fused_mbconv = True
    model = build_model(cfg.model.to_dict(), device="cpu",
                        generator=torch.Generator().manual_seed(3))
    opt = build_optimizer(cfg.optimizer.to_dict(), lambda s: 1e-4, model.named_parameters())
    root = tmp_path_factory.mktemp("clip")
    save_checkpoint(str(root / "best"), create_train_state(model, opt), config=cfg.to_dict(),
                    step=5)
    rows = _rows()
    path = root / "det.csv"
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return str(root / "best"), str(path), model.state_dict()


def _flags(clip_ckpt, work):
    return ["--clip-checkpoint", clip_ckpt[0], "--csv", clip_ckpt[1], "--image-dir",
            "synthetic://", "--resize", "64", "--batch-size", str(BATCH), "--device", "cpu",
            "--workdir", str(work)]


def test_detector_cli_trains_resumes_and_scores_every_image(clip_ckpt, tmp_path, capsys):
    work = tmp_path / "det"
    first = detector.main(_flags(clip_ckpt, work) + ["--epochs", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("epoch 1: mAP=") and json.loads(out[-1]) == first
    res = detector.main(_flags(clip_ckpt, work) + ["--epochs", "2", "--resume"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("resumed detector at epoch 1")
    assert out[1].startswith("epoch 2: mAP=") and json.loads(out[-1]) == res
    assert math.isfinite(res["best_mAP"]) and 0.0 <= res["best_mAP"] <= 1.0
    assert res["best_mAP"] >= first["best_mAP"]
    meta = json.loads((work / "checkpoints" / "2" / "meta.json").read_text())
    assert meta["epoch"] == 2 and meta["best_mAP"] == res["best_mAP"]
    payload = torch.load(work / "checkpoints" / "2" / "state.pt", weights_only=True)
    assert payload["step"] == 4  # 2 epochs of 8 // 4 steps
    # every validation image has its slate (R8): 6, not 4
    arrays = load_checkpoint_arrays(str(work / "best"))
    n_slots = len(VINDR_DETECTION_CLASSES) * 100
    assert arrays["boxes"].shape == (N_VALID, n_slots, 4)
    for k in ("scores", "classes", "valid"):
        assert arrays[k].shape == (N_VALID, n_slots)
    valid_tab = detector.build_detection_table(split_dataframe(load_metadata(clip_ckpt[1]),
                                                               "valid"),
                                               VINDR_DETECTION_CLASSES)
    np.testing.assert_array_equal(arrays["annotations"],
                                  np.stack([valid_tab[k] for k in sorted(valid_tab)]))
    # the JAX CLI's loop (full batches only) scores 4 of the 6
    store = SyntheticImageStore((64, 64))
    full = list(detector.batches(valid_tab, store, BATCH, "cpu"))
    padded = list(detector.batches(valid_tab, store, BATCH, "cpu", pad_last=True))
    assert sum(b["n_rows"] for b in full) == N_VALID - N_VALID % BATCH
    assert [b["n_rows"] for b in padded] == [4, 2]
    assert all(b["images"].shape == (BATCH, 64, 64, 1) for b in padded)
    assert padded[-1]["ids"] == sorted(valid_tab)[4:]


def test_detection_table_matches_jax(clip_ckpt):
    for split in ("train", "valid"):
        got = detector.build_detection_table(split_dataframe(load_metadata(clip_ckpt[1]), split),
                                             VINDR_DETECTION_CLASSES)
        want = jax_detector_cli.build_detection_table(
            jax_split(jax_load_metadata(clip_ckpt[1], parse_lists=True), split),
            VINDR_DETECTION_CLASSES)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["im9"][:2, 4] == [1, 0]).all()  # Suspicious Calcification, Mass


def test_detector_cli_multiscale_soft_nms_frozen_backbone(clip_ckpt, tmp_path, capsys):
    work = tmp_path / "det"
    res = detector.main(_flags(clip_ckpt, work) + ["--epochs", "1", "--eval-scales", "1.0,1.5",
                                                   "--soft-nms", "--freeze-backbone"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    assert 0.0 <= res["best_mAP"] <= 1.0
    arrays = load_checkpoint_arrays(str(work / "best"))
    assert arrays["scores"].shape == (N_VALID, len(VINDR_DETECTION_CLASSES) * 100)
    assert (arrays["scores"][~arrays["valid"]] == 0).all()
    payload = torch.load(work / "checkpoints" / "1" / "state.pt", weights_only=True)
    clip = clip_ckpt[2]
    enc = {k: v for k, v in payload["model"].items() if k.startswith("image_encoder.")}
    assert enc and all(torch.equal(v, clip[k]) for k, v in enc.items())
