"""The port's profiling hooks (``utils/profiling.py``), its metrics logger's
TensorBoard events and JSONL mirror (``utils/logging.py``) against the JAX
logger's, and the tutorials under ``mammo_clip_tpu_torch/examples/``, on the
CPU."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from mammo_clip_tpu.utils.logging import MetricsLogger as JaxMetricsLogger
from mammo_clip_tpu_torch.core.config import tiny_test_config
from mammo_clip_tpu_torch.data.png import read_png, write_png
from mammo_clip_tpu_torch.eval.embeddings import EmbeddingExtractor
from mammo_clip_tpu_torch.eval.loading import load_clip_for_eval
from mammo_clip_tpu_torch.examples import downstream_classifier, get_embeddings
from mammo_clip_tpu_torch.models import build_model
from mammo_clip_tpu_torch.preprocess.native_bindings import area_resize
from mammo_clip_tpu_torch.train import build_optimizer, create_train_state
from mammo_clip_tpu_torch.train.checkpoint import save_checkpoint
from mammo_clip_tpu_torch.train.schedule import warmup_cosine_sq_schedule
from mammo_clip_tpu_torch.utils import MetricsLogger, profile_trace, step_timer


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """1 intra-op thread: the suite runs its files in parallel processes, and
    torch's default of one thread per core in each oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with profile_trace(str(tmp_path / "trace")) as prof:
        y = (x @ x).relu().sum()
    assert float(y) > 0
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names and "aten::relu" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_step_timer_returns_one_time_per_call():
    calls = []

    def fn(x):
        calls.append(1)
        return {"loss": x.sum(), "aux": [x]}

    times = step_timer(fn, torch.ones(8), iters=4)
    assert len(times) == 4 == len(calls) and all(t >= 0 for t in times)
    synced = []
    times = step_timer(fn, torch.ones(8), iters=3,
                       sync_value=lambda out: synced.append(1) or out["loss"])
    assert len(times) == 3 == len(synced)


def _log_both(port_dir, jax_dir):
    for logger in (MetricsLogger(port_dir), JaxMetricsLogger(jax_dir)):
        logger.log(1, {"loss/total": 1.5, "lr": 1e-4})
        logger.log(2, {"loss/total": 1.25, "lr": 2e-4})
        logger.log(2, {"loss/total": 2.0}, prefix="valid")
        logger.close()


def test_logger_writes_tensorboard_events_and_the_jsonl_of_jax(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    port, ref = tmp_path / "port", tmp_path / "jax"
    _log_both(str(port), str(ref))
    strip = lambda d: [{k: v for k, v in json.loads(line).items() if k != "time"}
                       for line in (d / "metrics.jsonl").read_text().splitlines()]
    assert strip(port) == strip(ref)
    assert sorted(os.listdir(port / "tensorboard")) == sorted(os.listdir(ref / "tensorboard"))
    for prefix, want in (("train", [(1, 1.5), (2, 1.25)]), ("valid", [(2, 2.0)])):
        assert glob.glob(str(port / "tensorboard" / prefix / "events.out.tfevents.*"))
        acc = EventAccumulator(str(port / "tensorboard" / prefix))
        acc.Reload()
        got = [(e.step, e.value) for e in acc.Scalars("loss/total")]
        assert got == want


def test_disabled_logger_writes_nothing(tmp_path):
    logger = MetricsLogger(str(tmp_path / "off"), enabled=False)
    logger.log(1, {"loss/total": 1.0})
    logger.close()
    assert not (tmp_path / "off").exists()


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    cfg = tiny_test_config()
    model = build_model(cfg.model.to_dict(), device="cpu",
                        generator=torch.Generator().manual_seed(7))
    opt = build_optimizer(cfg.optimizer.to_dict(), warmup_cosine_sq_schedule(1e-4, 10, 1),
                          model.named_parameters())
    run = tmp_path_factory.mktemp("example") / "run"
    save_checkpoint(str(run / "checkpoints"), create_train_state(model, opt),
                    config=cfg.to_dict(), step=1)
    return str(run), cfg


def test_get_embeddings_example_on_the_cpu(tiny_checkpoint, tmp_path, capsys):
    """Two PNGs, one at the checkpoint's 64x64 and one at 80x70 (area-resized),
    embedded as the extractor embeds the decoded and resized arrays."""
    run, cfg = tiny_checkpoint
    rng = np.random.default_rng(0)
    paths = []
    for i, shape in enumerate(((64, 64), (80, 70))):
        paths.append(str(tmp_path / f"img{i}.png"))
        write_png(paths[-1], rng.integers(0, 256, shape, dtype=np.uint8))
    out = str(tmp_path / "emb.npy")
    emb = get_embeddings.main(["--checkpoint", run, "--images", *paths, "--out", out,
                               "--texts", "mass in the left breast.", "no finding.",
                               "--device", "cpu"])
    printed = capsys.readouterr().out
    assert f"saved (2, {cfg.model.projection_head.proj_dim})" in printed
    assert "cosine similarities" in printed
    np.testing.assert_array_equal(np.load(out), emb)
    model, _ = load_clip_for_eval(run, device="cpu")
    imgs = np.stack([read_png(paths[0]), area_resize(read_png(paths[1]), (64, 64))])[..., None]
    want = EmbeddingExtractor(model, cfg.data.mean, cfg.data.std).encode_images(imgs)
    np.testing.assert_allclose(emb, want, rtol=1e-6, atol=1e-7)


def test_downstream_classifier_example_runs_cli_classifier_lp(monkeypatch):
    seen = []
    monkeypatch.setattr(downstream_classifier.classifier, "main",
                        lambda argv: seen.append(argv) or {"best_metric": 0.5})
    res = downstream_classifier.main(["--checkpoint", "C", "--csv", "f.csv", "--device", "cpu"])
    assert res == {"best_metric": 0.5}
    assert seen == [["--clip-checkpoint", "C", "--arch", "lp", "--csv", "f.csv",
                     "--device", "cpu"]]
