"""The port's classifier entry points on the CPU (``--device cpu``):
``cli/classifier``, ``cli/rescore`` and the parity runner's classifier rows.

* cli/classifier, lp and ft, from a tiny port CLIP checkpoint (b0 at 64x64,
  the ft arm on the fused route): 1 epoch, then ``--resume`` to 2; the JSON
  line, ``best/`` with ``arrays.npz`` holding one prediction per
  (patient_id, laterality) group of the whole validation fold, the resume
  checkpoint's history, and the embedded config;
* fault R7: a validation fold of 6 rows at batch 4 is scored on all 6 rows
  here, and on 4 (6 - 6 % 4) by the JAX CLI's batching;
* cli/classifier trains with TF32 off, and restores the process's flags;
* cli/rescore's JSON equal to the JAX CLI's on the same predictions (binary,
  multi-class, a chosen metric), and the same ``SystemExit`` cases;
* the parity dry run with the lp and ft rows (``--selftest --skip-det
  --ft``) on the port's fake b2 ``.tar``: both arms of cli/classifier from a
  reference-format checkpoint.
"""

import csv
import json
import math
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mammo_clip_tpu.cli import classifier as jax_classifier_cli
from mammo_clip_tpu.cli import rescore as jax_rescore
from mammo_clip_tpu.data.datasets import ImageClassificationDataset as JaxClassificationDataset
from mammo_clip_tpu.data.images import SyntheticImageStore as JaxSyntheticStore
from mammo_clip_tpu.data.metadata import load_metadata as jax_load_metadata
from mammo_clip_tpu.data.metadata import split_dataframe as jax_split
from mammo_clip_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from mammo_clip_tpu_torch.cli import classifier, rescore
from mammo_clip_tpu_torch.core.config import tiny_test_config
from mammo_clip_tpu_torch.data.datasets import ImageClassificationDataset
from mammo_clip_tpu_torch.data.images import SyntheticImageStore
from mammo_clip_tpu_torch.data.metadata import load_metadata, split_dataframe
from mammo_clip_tpu_torch.models import build_model
from mammo_clip_tpu_torch.parity import run_parity
from mammo_clip_tpu_torch.train import build_optimizer, create_train_state
from mammo_clip_tpu_torch.train.checkpoint import load_checkpoint_arrays, save_checkpoint
from mammo_clip_tpu_torch.train.schedule import warmup_cosine_sq_schedule

BATCH = 4
# validation fold 0: 6 rows (6 % 4 = 2 rows past the last full batch), 4 groups
VALID = [("11", "L", 1), ("11", "L", 1), ("9", "R", 0), ("100", "L", 0), ("9", "R", 0),
         ("7", "R", 1)]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """1 intra-op thread: the suite runs its files in parallel
    processes, and torch's default of one thread per core in each oversubscribes
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def no_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return str(path)


@pytest.fixture(scope="module")
def clip_ckpt(tmp_path_factory):
    """A tiny port CLIP checkpoint (b0 at 64x64, fused route on) and an
    RSNA-style CSV: 8 training rows, the 6 validation rows of VALID."""
    cfg = tiny_test_config()
    cfg.model.image_encoder.fused_mbconv = True
    cfg.model.image_encoder.drop_connect_rate = 0.0
    model = build_model(cfg.model.to_dict(), device="cpu",
                        generator=torch.Generator().manual_seed(3))
    opt = build_optimizer(cfg.optimizer.to_dict(), warmup_cosine_sq_schedule(1e-4, 10, 1),
                          model.named_parameters())
    root = tmp_path_factory.mktemp("clip")
    save_checkpoint(str(root / "best"), create_train_state(model, opt), config=cfg.to_dict(),
                    step=5)
    rows = [{"patient_id": str(20 + i), "image_id": f"t{i}.png", "laterality": "LR"[i % 2],
             "cancer": i % 2, "fold": 1 + i % 2} for i in range(8)]
    rows += [{"patient_id": p, "image_id": f"v{i}.png", "laterality": lat, "cancer": c,
              "fold": 0} for i, (p, lat, c) in enumerate(VALID)]
    return str(root / "best"), _write_csv(root / "rsna.csv", rows)


@pytest.mark.parametrize("arch", ["lp", "ft"])
def test_classifier_cli_trains_resumes_and_keeps_every_row(clip_ckpt, arch, tmp_path, capsys):
    ckpt, csv_path = clip_ckpt
    work = tmp_path / "clf"
    flags = ["--clip-checkpoint", ckpt, "--csv", csv_path, "--image-dir", "synthetic://",
             "--arch", arch, "--batch-size", str(BATCH), "--weighted-bce", "--device", "cpu",
             "--workdir", str(work)]
    first = classifier.main(flags + ["--epochs", "1"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == first
    res = classifier.main(flags + ["--epochs", "2", "--resume"])
    out = capsys.readouterr().out.strip().splitlines()
    assert "resumed classifier at epoch 1" in out[0]
    assert json.loads(out[-1]) == res
    assert len(res["history"]) == 2 and res["history"][0] == first["history"][0]
    assert math.isfinite(res["best_metric"]) and 0.0 <= res["best_metric"] <= 1.0
    arrays = load_checkpoint_arrays(str(work / "best"))
    # every validation row is scored: one prediction per group of all 6 rows
    groups = sorted({(p, lat) for p, lat, _ in VALID})
    assert arrays["predictions"].shape == arrays["labels"].shape == (len(groups),)
    np.testing.assert_array_equal(arrays["labels"], [0, 1, 1, 0])  # "100", "11", "7", "9"
    assert rescore.main(["--checkpoint", str(work / "best")])["auroc"] == \
        pytest.approx(res["best_metric"], abs=1e-9)
    meta = json.loads((work / "checkpoints" / "2" / "meta.json").read_text())
    assert meta["epoch"] == 2 and meta["history"] == res["history"]
    step_dir = work / "best" / os.listdir(work / "best")[0]
    saved = json.loads((step_dir / "config.json").read_text())
    assert saved["arch"] == arch and saved["label"] == "cancer"
    assert saved["clip"]["model"]["image_encoder"]["fused_mbconv"] is True
    payload = torch.load(step_dir / "state.pt", weights_only=True)
    n_params = sum(not k.endswith(("mean", "var")) for k in payload["model"])
    # the optimizer holds the head alone in lp (kernel, bias), every parameter in ft
    assert len(payload["optimizer"]["inner"]["state"]) == (2 if arch == "lp" else n_params)


def test_r7_the_jax_cli_drops_validation_rows_the_port_scores(clip_ckpt):
    """Fault R7: the JAX CLI batches validation in full batches only."""
    _, csv_path = clip_ckpt
    jax_ds = JaxClassificationDataset(jax_split(jax_load_metadata(csv_path), "valid"),
                                      JaxSyntheticStore((64, 64)))
    jax_rows = sum(len(b["labels"]) for b in jax_classifier_cli._batches(jax_ds, BATCH, False))
    assert jax_rows == len(VALID) - len(VALID) % BATCH == 4
    ds = ImageClassificationDataset(split_dataframe(load_metadata(csv_path), "valid"),
                                    SyntheticImageStore((64, 64)))
    batches = list(classifier._batches(ds, BATCH, False, "cpu", pad_last=True))
    assert [b["n_rows"] for b in batches] == [4, 2]
    assert all(b["images"].shape[0] == BATCH for b in batches)  # one fixed shape
    # the pad rows repeat the fold's last row; the real rows are the dataset's
    np.testing.assert_array_equal(batches[1]["images"][1:].numpy(),
                                  np.stack([ds[5]["image"]] * 3)[..., None])
    got = np.concatenate([b["labels"][: b["n_rows"]].numpy() for b in batches])
    np.testing.assert_array_equal(got, [c for _, _, c in VALID])


def test_classifier_cli_trains_with_tf32_off(clip_ckpt, tmp_path, monkeypatch):
    """The CLI trains in full fp32 whatever the process had set (torch lets
    cuDNN take TF32 by default) and gives the process its flags back."""
    ckpt, csv_path = clip_ckpt
    seen = []

    def train(*args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return {"best_metric": 0.5, "history": []}

    monkeypatch.setattr(classifier, "train_classifier", train)
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        classifier.main(["--clip-checkpoint", ckpt, "--csv", csv_path, "--image-dir",
                         "synthetic://", "--device", "cpu", "--workdir", str(tmp_path)])
        after = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
    assert seen == [(False, False)] and after == (True, True)


def _both_checkpoints(tmp_path, predictions, labels):
    """The same arrays under a JAX (Orbax) and a port checkpoint directory."""
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    state = types.SimpleNamespace(step=jnp.asarray(3), params={"w": jnp.zeros(2)},
                                  batch_stats={}, opt_state={}, ema_params=None)
    arrays = {"predictions": predictions, "labels": labels}
    jax_save_checkpoint(str(jax_dir), state, extra_arrays=arrays)
    model = torch.nn.Linear(2, 1)
    opt = build_optimizer({"name": "adamw"}, lambda s: 0.0, model.named_parameters())
    port_state = create_train_state(model, opt)
    port_state.step = 3
    save_checkpoint(str(port_dir), port_state, extra_arrays=arrays)
    return str(jax_dir), str(port_dir)


@pytest.mark.parametrize("case", ["binary", "binary_auroc_only", "multiclass"])
def test_rescore_cli_matches_jax(case, tmp_path, capsys):
    rng = np.random.default_rng(2)
    if case == "multiclass":
        logits = rng.standard_normal((12, 4))
        preds = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
        labels = rng.integers(0, 4, 12).astype(np.float32)
    else:
        preds = rng.random(12).astype(np.float32)
        labels = np.asarray([0, 1] * 6, np.float32)
    jax_dir, port_dir = _both_checkpoints(tmp_path, preds, labels)
    extra = ["--metric", "auroc"] if case == "binary_auroc_only" else ["--threshold", "0.4"]
    jax_rescore.main(["--checkpoint", jax_dir] + extra)
    want = capsys.readouterr().out
    got = rescore.main(["--checkpoint", port_dir] + extra)
    assert capsys.readouterr().out == want
    assert got == json.loads(want)
    if case == "multiclass":  # pfbeta is binary: the same refusal
        with pytest.raises(SystemExit) as a:
            jax_rescore.main(["--checkpoint", jax_dir, "--metric", "pfbeta"])
        with pytest.raises(SystemExit) as b:
            rescore.main(["--checkpoint", port_dir, "--metric", "pfbeta"])
        assert str(a.value) == str(b.value)


def test_rescore_cli_without_arrays_exits(tmp_path):
    with pytest.raises(SystemExit) as a:
        jax_rescore.main(["--checkpoint", str(tmp_path / "none")])
    with pytest.raises(SystemExit) as b:
        rescore.main(["--checkpoint", str(tmp_path / "none")])
    assert str(a.value).replace(str(tmp_path), "") == str(b.value).replace(str(tmp_path), "")


def test_parity_dry_run_with_the_classifier_rows(tmp_path, capsys):
    out = tmp_path / "parity.json"
    payload = run_parity.main(["--selftest", "--skip-det", "--ft", "--device", "cpu",
                               "--out", str(out)])
    assert json.loads(out.read_text()) == payload
    rows = {r["row"]: r["ours"] for r in payload["rows"]}
    assert set(rows) == {"zs_vindr/mass", "zs_vindr/suspicious_calcification",
                         "zs_rsna/malignancy", "lp_rsna/cancer", "ft_rsna/cancer"}
    assert all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in rows.values())
    assert payload["verdict"].startswith("UNSCORED")
    assert "selftest OK" in capsys.readouterr().out
