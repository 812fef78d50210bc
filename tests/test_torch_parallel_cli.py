"""``cli/pretrain`` on 2 gloo CPU ranks (data parallelism, ``core/mesh.py``).

Both ranks run the tiny config (b0 at 64x64, 2-layer BERT, fp32, no
augmentation, dropout or drop-connect, an EMA) on ``synthetic://`` images, 2
rows a rank a step, 2 epochs of 2 steps: run A is sent SIGTERM on rank 1 alone
during its first step and then resumed with ``--resume``, run B runs straight
through. The ranks are spawned once for the file
(``parallel/dryrun.py::run_ranks``, with a timeout on the spawn and on
``init_process_group``) and return their numbers to this process.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from mammo_clip_tpu_torch.parallel.dryrun import run_ranks

RANKS, BATCH, TRAIN_STEPS = 2, 2, 2
WORKERS = str(Path(__file__).with_name("torch_parallel_ranks.py"))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """1 intra-op thread: the suite runs its files in parallel processes, and
    torch's default of one thread per core in each oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _write_csv(path, n, n_train):
    """n patient rows with two views and two reports; the first ``n_train`` in
    fold 1 (training), the rest in fold 0 (validation)."""
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["patient_id", "laterality", "image", "view", "CC", "MLO", "text",
                    "text_augment", "fold"])
        for i in range(n):
            w.writerow([f"p{i}", "L", str([f"i{i}a.png", f"i{i}b.png"]), str(["CC", "MLO"]),
                        str([f"i{i}a.png"]), str([f"i{i}b.png"]),
                        str([f"there is a mass in sample {i}.", f"impression {i}."]),
                        str([f"a mass in sample {i}.", f"imp {i}."]), int(i < n_train)])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_cli")
    # 8 train rows (4 a rank after the strided split: 2 steps of 2), 4 validation (1 batch)
    _write_csv(tmp / "pretrain.csv", 12, 8)
    entry = json.dumps([{"csv": str(tmp / "pretrain.csv"), "image_dir": "synthetic://",
                         "data_type": "imagetext"}])
    overrides = [
        "model.image_encoder.name=efficientnet-b0", "model.image_encoder.fused_mbconv=true",
        "model.image_encoder.drop_connect_rate=0.0", "model.text_encoder.dropout_rate=0.0",
        "model.text_encoder.vocab_size=128", "model.text_encoder.hidden_size=32",
        "model.text_encoder.num_layers=2", "model.text_encoder.num_heads=2",
        "model.text_encoder.intermediate_size=64",
        "model.text_encoder.max_position_embeddings=64", "model.projection_head.proj_dim=32",
        "model.projection_head.dropout=0.0", "data.image_size_h=64", "data.image_size_w=64",
        "data.text_max_length=16", f"data.batch_size_per_device={BATCH}",
        f"data.train={entry}", f"data.valid={entry}", "scheduler.warmup_epochs=0",
        "train.dtype=float32", "train.log_every=1", "optimizer.eps=1e-3", "scheduler.epochs=2",
        "optimizer.ema_decay=0.9", "augment.hflip_p=0.0", "augment.vflip_p=0.0",
        "augment.affine_p=0.0", "augment.elastic_p=0.0"]
    # the spawn's limit is about twice what the file takes under the suite's load
    out = run_ranks(RANKS, f"{WORKERS}:cli", {"tmp": str(tmp), "overrides": overrides,
                                              "timeout_s": 60.0}, device="cpu", timeout_s=150.0)
    return tmp, out


def test_sigterm_on_one_rank_and_resume_end_equal_on_every_rank(ranks):
    """SIGTERM on rank 1 alone stops both ranks after the same step, with one
    checkpoint; ``--resume`` then ends both with the bits of the run that was
    never stopped (parameters, BatchNorm statistics, EMA), the same on both
    ranks. Each rank takes 2 steps an epoch: the global batch of 4 is 2 rows a
    rank (fault R11 of the reference not inherited)."""
    _, out = ranks
    for r in out:
        assert r["a"]["steps"] == [1, 2 * TRAIN_STEPS]
        assert r["b"]["steps"] == [2 * TRAIN_STEPS]
        assert r["a"]["digest"] == r["b"]["digest"] == out[0]["a"]["digest"]
        assert r["a"]["ema"] == r["b"]["ema"] == out[0]["a"]["ema"]
        assert r["a"]["opt_count"] == 2 * TRAIN_STEPS


def test_rank_zero_writes_one_checkpoint_a_step(ranks):
    """Rank 0 alone writes: each checkpoint step once (the SIGTERM flush at step
    1, then the epochs' ends; no rank's temporary directory left), one
    ``best/``, one config and one metrics file with finite losses, the
    validation's the ranks' mean (the same in the resumed and the straight run)."""
    tmp, out = ranks
    run = tmp / "a"
    names = sorted(os.listdir(run / "checkpoints"), key=int)
    assert names == ["1", str(TRAIN_STEPS), str(2 * TRAIN_STEPS)]
    assert json.loads((run / "checkpoints" / "1" / "meta.json").read_text())["preempted"]
    for step in names:
        assert sorted(os.listdir(run / "checkpoints" / step)) == [
            "config.json", "meta.json", "state.pt"]
    assert len(os.listdir(run / "best")) == 1
    assert json.loads((run / "config.json").read_text())["data"]["batch_size_per_device"] == BATCH
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in rows if r["prefix"] == "train"]
    valid = [r for r in rows if r["prefix"] == "valid"]
    assert [r["step"] for r in train] == list(range(2, 2 * TRAIN_STEPS + 1))  # log_every 1
    assert len(valid) == 2
    assert all(np.isfinite(r["loss/total"]) for r in train + valid)
    straight = [json.loads(line) for line in (tmp / "b" / "metrics.jsonl").read_text().splitlines()]
    assert [r["loss/total"] for r in valid] == [
        r["loss/total"] for r in straight if r["prefix"] == "valid"]
    meta = json.loads((run / "checkpoints" / str(2 * TRAIN_STEPS) / "meta.json").read_text())
    assert meta["epoch"] == 2 and meta["step"] == 2 * TRAIN_STEPS
