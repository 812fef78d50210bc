"""The port's evaluation entry points on the CPU (``--device cpu``):
``cli/zeroshot``, ``cli/retrieval``, ``cli/validate`` and the parity dry run.

* zeroshot / retrieval: the CLI's JSON (stdout, ``--out`` and the return value)
  against the JAX package's ``eval_zeroshot`` / ``eval_image_text_retrieval`` on
  the JAX package's embeddings of the same store rows (its extractor over the
  same weights, carried across with ``variables_from_state_dict``), within 1e-6;
  the retrieval dataset's items equal the JAX dataset's;
* validate: on a tiny pretraining run of ``cli/pretrain`` (fp32 activations),
  one finite loss per checkpointed step, equal to ``make_eval_step`` on the
  restored states and to the validation loss the trainer logged at that step
  (the same fp32 computation), ``best_step`` the argmin; ``config.yaml`` read
  when it is the only config and PyYAML is present, refused when it is absent;
* the parity dry run on the port's own b2 fake: the three zero-shot rows and
  the detection row (cli/detector at 64x64, 1 epoch), finite, verdict
  UNSCORED (the classifier rows' dry run is in ``test_torch_classifier_cli.py``).

``transformers`` is made unimportable in these tests, as on the card machine,
so both packages' ``load_tokenizer`` give the hashing tokenizer.
"""

import csv
import json
import math
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from mammo_clip_tpu.core.config import tiny_test_config as jax_tiny_config
from mammo_clip_tpu.data.datasets import ImageTextRetrievalDataset as JaxRetrievalDataset
from mammo_clip_tpu.data.images import SyntheticImageStore as JaxSyntheticStore
from mammo_clip_tpu.data.metadata import load_metadata as jax_load_metadata
from mammo_clip_tpu.data.tokenizer import load_tokenizer as jax_load_tokenizer
from mammo_clip_tpu.eval.embeddings import EmbeddingExtractor as JaxExtractor
from mammo_clip_tpu.eval.retrieval import eval_image_text_retrieval as jax_retrieval
from mammo_clip_tpu.eval.zeroshot import DEFAULT_ZS_PROMPTS, eval_zeroshot as jax_eval_zeroshot
from mammo_clip_tpu.models import build_model as jax_build_model
from mammo_clip_tpu_torch.cli import pretrain, retrieval, validate, zeroshot
from mammo_clip_tpu_torch.convert.from_jax import variables_from_state_dict
from mammo_clip_tpu_torch.core.config import tiny_test_config
from mammo_clip_tpu_torch.data.datasets import ImageTextRetrievalDataset
from mammo_clip_tpu_torch.data.images import SyntheticImageStore
from mammo_clip_tpu_torch.data.metadata import load_metadata
from mammo_clip_tpu_torch.losses import build_loss
from mammo_clip_tpu_torch.models import build_model
from mammo_clip_tpu_torch.parity import run_parity
from mammo_clip_tpu_torch.train import build_optimizer, create_train_state, make_eval_step
from mammo_clip_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from mammo_clip_tpu_torch.train.schedule import warmup_cosine_sq_schedule
from mammo_clip_tpu_torch.train.trainer import make_clip_preprocess


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
def clip_run(tmp_path_factory):
    """A port checkpoint of the tiny CLIP, the JAX extractor over the same
    weights, and the config."""
    cfg = tiny_test_config()
    assert cfg.to_dict() == jax_tiny_config().to_dict()
    model = build_model(cfg.model.to_dict(), device="cpu",
                        generator=torch.Generator().manual_seed(5))
    opt = build_optimizer(cfg.optimizer.to_dict(), warmup_cosine_sq_schedule(1e-4, 10, 1),
                          model.named_parameters())
    run = tmp_path_factory.mktemp("clip") / "run"
    save_checkpoint(str(run / "checkpoints"), create_train_state(model, opt),
                    config=cfg.to_dict(), step=1)
    jm = jax_build_model(cfg.model.to_dict())
    tree = variables_from_state_dict(model.state_dict())
    extractor = JaxExtractor(jm, tree, cfg.data.mean, cfg.data.std, batch_size=4)
    return str(run), extractor, cfg


def _jax_tokenizer(cfg):
    return jax_load_tokenizer({"vocab_size": cfg.model.text_encoder.vocab_size,
                               "name": cfg.model.text_encoder.name})


def _stdout_json(capsys):
    return json.loads(capsys.readouterr().out)


def test_zeroshot_cli_matches_jax(clip_run, tmp_path, capsys):
    run, extractor, cfg = clip_run
    rng = np.random.default_rng(0)
    rows = [{"patient_id": f"p{i}", "image_id": f"im{i}.png", "Mass": int(rng.integers(0, 2)),
             "Suspicious_Calcification": int(i % 2)} for i in range(10)]
    rows[0]["Mass"], rows[1]["Mass"] = 0, 1
    path = _write_csv(tmp_path / "zs.csv", rows)
    out = tmp_path / "zs.json"
    got = zeroshot.main(["--checkpoint", run, "--csv", path, "--image-dir", "synthetic://",
                         "--batch-size", "4", "--out", str(out), "--device", "cpu"])
    assert _stdout_json(capsys) == got == json.loads(out.read_text())

    store = JaxSyntheticStore((cfg.data.image_size_h, cfg.data.image_size_w))
    images = np.stack([store.get(r["patient_id"], r["image_id"]) for r in rows])[..., None]
    labels = {"mass": np.array([r["Mass"] for r in rows]),
              "calc": np.array([r["Suspicious_Calcification"] for r in rows])}
    want = jax_eval_zeroshot(extractor, _jax_tokenizer(cfg), extractor.encode_images(images),
                             labels, DEFAULT_ZS_PROMPTS["vindr"],
                             max_length=cfg.data.text_max_length)
    assert set(got) == set(want) == {"mass", "suspicious_calcification"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


def test_retrieval_cli_matches_jax(clip_run, tmp_path, capsys):
    run, extractor, cfg = clip_run
    rows = [{"patient_id": f"p{i}", "image": str([f"im{i}a.png", f"im{i}b.png"]),
             "text": str([f"finding {i % 5}.", "no change."]), "fold": 0} for i in range(12)]
    path = _write_csv(tmp_path / "ret.csv", rows)
    got = retrieval.main(["--checkpoint", run, "--csv", path, "--image-dir", "synthetic://",
                          "--batch-size", "4", "--device", "cpu"])
    assert _stdout_json(capsys) == got

    size = (cfg.data.image_size_h, cfg.data.image_size_w)
    ours = ImageTextRetrievalDataset(load_metadata(path), SyntheticImageStore(size))
    theirs = JaxRetrievalDataset(jax_load_metadata(path), JaxSyntheticStore(size))
    items = [theirs[i] for i in range(len(theirs))]
    for i, item in enumerate(items):
        mine = ours[i]
        assert mine["text"] == item["text"] and np.array_equal(mine["image"], item["image"])
    texts = [it["text"] for it in items]
    enc = _jax_tokenizer(cfg)(texts, max_length=cfg.data.text_max_length)
    want = jax_retrieval(extractor.encode_images(np.stack([it["image"] for it in items])[..., None]),
                         extractor.encode_texts(enc["input_ids"], enc["attention_mask"]), texts)
    assert got.keys() == want.keys() and got["retrieval_i2t"].keys() == want["retrieval_i2t"].keys()
    for k, v in want["retrieval_i2t"].items():
        assert abs(got["retrieval_i2t"][k] - v) <= 1e-6, (k, got["retrieval_i2t"][k], v)


@pytest.fixture(scope="module")
def pretrain_run(tmp_path_factory):
    """A tiny ``cli/pretrain`` run of 2 epochs (checkpoints at steps 3 and 6)."""
    work = tmp_path_factory.mktemp("pretrain")
    path = _write_csv(work / "pretrain.csv", [
        {"patient_id": f"p{i}", "image": str([f"i{i}.png"]), "text": str([f"mass {i}."]),
         "fold": i % 4} for i in range(8)])
    entry = json.dumps([{"csv": path, "image_dir": "synthetic://"}])
    tiny = ["model.image_encoder.name=efficientnet-b0", "data.image_size_h=32",
            "data.image_size_w=32", "data.text_max_length=8",
            "model.text_encoder.num_layers=1", "model.text_encoder.hidden_size=16",
            "model.text_encoder.num_heads=2", "model.text_encoder.intermediate_size=32",
            "model.text_encoder.vocab_size=64", "model.projection_head.proj_dim=8",
            f"data.train={entry}", f"data.valid={entry}", "data.batch_size_per_device=2",
            "scheduler.warmup_epochs=0", "train.dtype=float32", "scheduler.epochs=2"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "transformers", None)
        pretrain.main(["--device", "cpu", "--workdir", str(work / "run"), "--variant", "b2"]
                      + tiny)
    return work / "run"


def _eval_step_losses(workdir, steps):
    """make_eval_step over the validation batches on each restored state."""
    from mammo_clip_tpu_torch.core.config import Config
    from mammo_clip_tpu_torch.data.datamodule import DataModule

    cfg = Config.from_json((workdir / "config.json").read_text())
    model = build_model(cfg.model.to_dict(), device="cpu")
    state = create_train_state(model, build_optimizer(
        cfg.optimizer.to_dict(), warmup_cosine_sq_schedule(1e-4, 10, 1), model.named_parameters()))
    step_fn = make_eval_step(model, build_loss(cfg.loss.to_dict()), make_clip_preprocess(cfg))
    valid_b = DataModule(cfg).batcher("valid")
    out = {}
    for step in steps:
        restore_checkpoint(str(workdir / "checkpoints"), state, step=step)
        losses = [float(step_fn(state, {k: torch.from_numpy(v).long() if v.dtype == np.int32
                                         else torch.from_numpy(v) for k, v in b.items()}
                                )["contrastive"]) for b in valid_b]
        out[step] = float(np.mean(losses))
    return out


@pytest.mark.parametrize("config_file", ["json", "yaml", "yaml_without_pyyaml"])
def test_validate_cli(pretrain_run, tmp_path, capsys, monkeypatch, config_file):
    workdir = tmp_path / "run"
    shutil.copytree(pretrain_run, workdir)
    if config_file != "json":
        import yaml

        cfg = json.loads((workdir / "config.json").read_text())
        (workdir / "config.yaml").write_text(yaml.safe_dump(cfg))
        os.remove(workdir / "config.json")
    if config_file == "yaml_without_pyyaml":
        monkeypatch.setitem(sys.modules, "yaml", None)
        with pytest.raises(RuntimeError, match="PyYAML"):
            validate.main(["--workdir", str(workdir), "--device", "cpu"])
        return
    summary = validate.main(["--workdir", str(workdir), "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("step 3 (epoch 1): contrastive=")
    assert lines[1].startswith("step 6 (epoch 2): contrastive=")
    assert json.loads(lines[-1]) == {"best_step": summary["best_step"],
                                     "losses": {str(k): v for k, v in summary["losses"].items()}}
    losses = summary["losses"]
    assert sorted(losses) == [3, 6] and all(math.isfinite(v) for v in losses.values())
    assert summary["best_step"] == min(losses, key=losses.get)
    want = _eval_step_losses(pretrain_run, [3, 6])
    logged = {r["step"]: r["loss/contrastive"] for r in map(
        json.loads, (pretrain_run / "metrics.jsonl").read_text().splitlines())
        if r["prefix"] == "valid"}
    for step in (3, 6):
        assert losses[step] == pytest.approx(want[step], rel=1e-6)
        assert losses[step] == pytest.approx(logged[step], rel=1e-5)


def test_parity_dry_run(tmp_path, capsys):
    """The zero-shot rows and the detection row (cli/detector on the fake b2
    ``.tar`` at 64x64, 1 epoch); ``test_torch_classifier_cli.py``'s dry run
    leaves the detection row out with ``--skip-det``."""
    out = tmp_path / "parity.json"
    payload = run_parity.main(["--selftest", "--skip-lp", "--device", "cpu",
                               "--out", str(out)])
    assert json.loads(out.read_text()) == payload
    rows = {r["row"]: r["ours"] for r in payload["rows"]}
    assert set(rows) == {"zs_vindr/mass", "zs_vindr/suspicious_calcification",
                         "zs_rsna/malignancy", "det_vindr/mAP"}
    assert all(math.isfinite(v) for v in rows.values())
    assert 0.0 <= rows["det_vindr/mAP"] <= 1.0
    assert payload["verdict"].startswith("UNSCORED")
    printed = capsys.readouterr().out
    assert "parity verdict: UNSCORED" in printed and "selftest OK" in printed
    assert "epoch 1: mAP=" not in printed  # the detector's lines are captured
