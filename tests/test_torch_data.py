"""The port's data layer (mammo_clip_tpu_torch/data, utils/logging) against the
JAX package's: token ids, prompt text, parsed CSV metadata (the file written
with pandas, read by the port with ``csv``), splits and subsampling, dataset
items, the Batcher's order per epoch, the DataModule, and the device prefetch
(on the CPU here: its thread must not outlive the iterator). Everything here is
exact: the same inputs give the same ids, strings, pixels and orders.

SyntheticImageStore seeds its pixels from Python's per-process ``hash``, so the
two packages' images agree because both run in this one process.
"""

import json
import random
import threading

import numpy as np
import pandas as pd
import pytest
import torch

from mammo_clip_tpu.core.config import tiny_test_config as jax_tiny_config
from mammo_clip_tpu.data import datamodule as jax_dm
from mammo_clip_tpu.data import datasets as jax_ds
from mammo_clip_tpu.data import images as jax_images
from mammo_clip_tpu.data import metadata as jax_meta
from mammo_clip_tpu.data import pipeline as jax_pipe
from mammo_clip_tpu.data import prompts as jax_prompts
from mammo_clip_tpu.data import tokenizer as jax_tok
from mammo_clip_tpu_torch.core.config import tiny_test_config
from mammo_clip_tpu_torch.data import datamodule, datasets, images, metadata, pipeline, prompts
from mammo_clip_tpu_torch.data import tokenizer as tok
from mammo_clip_tpu_torch.utils.logging import AverageMeter, MetricsLogger


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """1 intra-op thread: the suite runs its files in parallel
    processes, and torch's default of one thread per core in each oversubscribes
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TEXTS = ["There is a MASS in the upper-outer quadrant.", "no evidence; benign (BI-RADS 2)",
         "", "calcifications, clustered, café-au-lait spot", "breakfast ma mass"]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "there", "is", "a", "mass", "ma", "##ss",
         "##s", "break", "##fast", "in", "upper", "-", "outer", ".", ",", ";", "(", ")", "no",
         "benign", "2", "calc", "##ifications"]


def _pretrain_frame(n=12):
    return pd.DataFrame([{
        "patient_id": 10000 + i,  # numeric-looking ids stay strings in both packages
        "laterality": "R" if i % 2 else "L",
        "image": str([f"i{i}a.png", f"i{i}b.png"]),
        "view": str(["CC", "MLO"]),
        "CC": str([f"i{i}a.png"]),
        "MLO": str([f"i{i}b.png"]),
        "text": str([f"there is a mass in sample {i}. It is small.", f"impression {i}."]),
        "text_augment": str([f"a mass in sample {i}.", f"imp {i}."]),
        "BIRADS": float(i % 5) if i % 3 else None,  # numeric with gaps -> float, 0-filled
        "age": 40 + i,
        "note": None if i % 4 == 0 else f"n{i}",  # strings with gaps
        "fold": i % 4,
    } for i in range(n)])


def _vindr_frame():
    return pd.DataFrame([{
        "patient_id": f"v{i}", "image": str(["a.png", "b.png"]), "view": str(["CC", "MLO"]),
        "CC": str(["a.png"]), "MLO": str(["b.png"]),
        "CC_FINDING": str([["Mass"], [], [], ["Suspicious Calcification"]]),
        "MLO_FINDING": str([["No Finding"] if i % 2 else [], [], ["Mass"], []]),
        "split": "training" if i < 3 else "test",
    } for i in range(5)])


@pytest.fixture
def csv_path(tmp_path):
    path = tmp_path / "pretrain.csv"
    _pretrain_frame().to_csv(path, index=False)
    return str(path)


def _records(df):
    """DataFrame rows with pandas' NaN as None (the port's empty string cell)."""
    return [{k: (None if isinstance(v, float) and np.isnan(v) else v) for k, v in r.items()}
            for r in df.to_dict("records")]


# ---------------------------------------------------------------- tokenizer


@pytest.mark.parametrize("kind", ["wordpiece", "vocab_file", "hash"])
def test_token_ids_match_jax(kind, tmp_path):
    if kind == "wordpiece":
        vocab = {t: i for i, t in enumerate(VOCAB)}
        ours, ref = tok.WordPieceTokenizer(vocab, True), jax_tok.WordPieceTokenizer(vocab, True)
    elif kind == "vocab_file":
        path = tmp_path / "vocab.txt"
        path.write_text("\n".join(VOCAB) + "\n")
        ours = tok.WordPieceTokenizer.from_vocab_file(str(path))
        ref = jax_tok.WordPieceTokenizer.from_vocab_file(str(path))
    else:
        ours, ref = tok.HashTokenizer(vocab_size=500), jax_tok.HashTokenizer(vocab_size=500)
    for max_length in (6, 16):
        a, b = ours(TEXTS, max_length=max_length), ref(TEXTS, max_length=max_length)
        for k in ("input_ids", "attention_mask"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_load_tokenizer_matches_jax(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n")
    for cfg in ({"vocab_file": str(path)}, {"vocab_size": 300}, {}):
        ours, ref = tok.load_tokenizer(dict(cfg)), jax_tok.load_tokenizer(dict(cfg))
        assert type(ours).__name__ == type(ref).__name__
        np.testing.assert_array_equal(ours(TEXTS, 12)["input_ids"], ref(TEXTS, 12)["input_ids"])


# ---------------------------------------------------------------- prompts


def test_prompt_text_matches_jax():
    assert prompts.build_prompt_bank() == jax_prompts.build_prompt_bank()
    assert prompts.VINDR_FINDINGS == jax_prompts.VINDR_FINDINGS
    bank = prompts.build_prompt_bank()
    findings = [["Mass", "Asymmetry"], ["Suspicious Calcification"], ["Skin Thickening"],
                ["Mass", "Nipple Retraction"]]
    for deterministic in (True, False):
        for seed in range(4):
            a = prompts.generate_report_from_labels(findings, bank, deterministic,
                                                    rng=random.Random(seed))
            b = jax_prompts.generate_report_from_labels(findings, bank, deterministic,
                                                        rng=random.Random(seed))
            assert a == b


# ---------------------------------------------------------------- metadata


@pytest.mark.parametrize("parse_lists", [True, False])
def test_metadata_matches_jax(csv_path, parse_lists):
    ours = metadata.load_metadata(csv_path, parse_lists=parse_lists)
    ref = jax_meta.load_metadata(csv_path, parse_lists=parse_lists)
    assert list(ours.columns) == list(ref.columns)
    assert list(ours) == _records(ref)
    assert all(type(r["age"]) is int and type(r["BIRADS"]) is float for r in ours)
    assert ours[0]["patient_id"] == "10000"


def test_parse_list_cell_matches_jax():
    for cell in ["['a.png', 'b.png']", "plain.png", ["x"], "[broken", 3, float("nan"), None,
                 "[['Mass'], []]", "('a', 'b')"]:
        assert metadata.parse_list_cell(cell) == jax_meta.parse_list_cell(cell)


def test_splits_and_subsample_match_jax(csv_path, tmp_path):
    ours, ref = metadata.load_metadata(csv_path), jax_meta.load_metadata(csv_path)
    for split in ("train", "valid", "test"):
        for fold in (0, 2):
            a = metadata.split_dataframe(ours, split, cur_fold=fold)
            b = jax_meta.split_dataframe(ref, split, cur_fold=fold)
            assert list(a) == _records(b)
    for frac, seed in ((0.5, 0), (0.34, 7), (1.0, 0)):
        assert list(metadata.subsample(ours, frac, seed)) == _records(
            jax_meta.subsample(ref, frac, seed))
    vpath = tmp_path / "vindr.csv"
    _vindr_frame().to_csv(vpath, index=False)
    v_ours, v_ref = metadata.load_metadata(str(vpath)), jax_meta.load_metadata(str(vpath))
    for split in ("train", "valid"):
        assert (list(metadata.split_dataframe(v_ours, split))
                == _records(jax_meta.split_dataframe(v_ref, split)))


# ---------------------------------------------------------------- images, datasets


def test_image_stores_match_jax(tmp_path):
    a, b = images.SyntheticImageStore((20, 12)), jax_images.SyntheticImageStore((20, 12))
    np.testing.assert_array_equal(a.get("p1", "x.png"), b.get("p1", "x.png"))
    root = tmp_path / "shards"
    root.mkdir()
    np.save(root / "shard_00000.npy", np.arange(3 * 4 * 5, dtype=np.uint8).reshape(3, 4, 5))
    pd.DataFrame({"image_id": ["007", "b", "c"], "shard": [0, 0, 0], "row": [2, 0, 1]}).to_csv(
        root / "index.csv", index=False)
    ours, ref = images.open_image_store(str(root)), jax_images.open_image_store(str(root))
    assert isinstance(ours, images.PackedShardStore) and "007" in ours
    np.testing.assert_array_equal(ours.get_rows(["007", "c"]), ref.get_rows(["007", "c"]))
    assert isinstance(images.open_image_store(str(tmp_path / "pngs")), images.DirectoryImageStore)


def _items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("split", ["train", "valid"])
def test_imagetext_items_match_jax(csv_path, tmp_path, split):
    store = images.SyntheticImageStore((16, 12))
    ours = datasets.load_dataset("imagetext", df=metadata.load_metadata(csv_path),
                                 image_store=store, split=split, seed=3)
    ref = jax_ds.load_dataset("imagetext", df=jax_meta.load_metadata(csv_path),
                              image_store=store, split=split, seed=3)
    vpath = tmp_path / "vindr.csv"
    _vindr_frame().to_csv(vpath, index=False)
    v_ours = datasets.ImageTextDataset(metadata.load_metadata(str(vpath)), store, split=split)
    v_ref = jax_ds.ImageTextDataset(jax_meta.load_metadata(str(vpath)), store, split=split)
    for epoch in (0, 1, 5):
        for a, b in ((ours, ref), (v_ours, v_ref)):
            a.reseed(epoch)
            b.reseed(epoch)
            for i in range(len(b)):
                _items_equal(a[i], b[i])


def test_contrastive_items_match_jax(csv_path):
    store = images.SyntheticImageStore((8, 8))
    ours = datasets.load_dataset("imagetext_contrastive", df=metadata.load_metadata(csv_path),
                                 image_store=store, seed=1)
    ref = jax_ds.load_dataset("imagetext_contrastive", df=jax_meta.load_metadata(csv_path),
                              image_store=store, seed=1)
    for i in range(len(ref)):
        _items_equal(ours[i], ref[i])


def _meta_value(v):
    """A JAX meta cell as the port's row holds it: pandas' NaN is None."""
    return None if isinstance(v, float) and np.isnan(v) else v


@pytest.mark.parametrize("table", ["pretrain", "study"])
def test_image_aligner_items_match_jax(csv_path, tmp_path, table):
    """``load_dataset("image_aligner")`` item by item against JAX's: the image
    (a list cell gives its first element; the study is ``patient_id``, else
    ``study_id``) and every other column verbatim in ``meta``."""
    if table == "pretrain":
        path, image_col = csv_path, "image"
    else:
        path, image_col = str(tmp_path / "study.csv"), "image_id"
        pd.DataFrame([{"study_id": f"s{i}", "image_id": f"img{i}.png", "Mass": i % 2,
                       "density": "ABCD"[i % 4], "threshold": 0.25 * i} for i in range(6)]
                     ).to_csv(path, index=False)
    store = images.SyntheticImageStore((8, 8))
    ours = datasets.load_dataset("image_aligner", df=metadata.load_metadata(path),
                                 image_store=store, image_col=image_col)
    ref = jax_ds.load_dataset("image_aligner", df=jax_meta.load_metadata(path),
                              image_store=store, image_col=image_col)
    assert isinstance(ours, datasets.ImageAlignerDataset) and len(ours) == len(ref)
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        np.testing.assert_array_equal(a["image"], b["image"])
        assert a["meta"] == {k: _meta_value(v) for k, v in b["meta"].items()}
        assert image_col not in a["meta"]
    with pytest.raises(KeyError):
        datasets.load_dataset("image_grounding", df=None, image_store=store)


def _batches_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_batcher_order_matches_jax(csv_path):
    store = images.SyntheticImageStore((16, 12))
    hash_tok = tok.HashTokenizer(vocab_size=200)
    ds_ours = datasets.ImageTextDataset(metadata.load_metadata(csv_path), store)
    ds_ref = jax_ds.ImageTextDataset(jax_meta.load_metadata(csv_path), store)
    for shuffle in (True, False):
        ours = pipeline.Batcher(ds_ours, hash_tok, 5, max_length=16, shuffle=shuffle, seed=5)
        ref = jax_pipe.Batcher(ds_ref, hash_tok, 5, max_length=16, shuffle=shuffle, seed=5,
                               process_index=0, process_count=1)
        assert len(ours) == len(ref) == 2  # 12 rows: the partial batch is dropped
        for epoch in (0, 1, 2):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = list(ours), list(ref)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                _batches_equal(a, b)
    stacked = pipeline.stack_batches(got[:2])
    _batches_equal(stacked, jax_pipe.stack_batches(want[:2]))
    assert stacked["images"].shape[:2] == (2, 5)
    assert [len(g) for g in pipeline.group_batches(iter(got + got[:1]), 2)] == [2]


def test_datamodule_matches_jax(csv_path):
    """Two train entries (ConcatDataset), a fold split and data_frac."""
    batches = []
    for cfg, dm in ((tiny_test_config(), datamodule.DataModule),
                    (jax_tiny_config(), jax_dm.DataModule)):
        entry = {"csv": csv_path, "image_dir": "synthetic://", "data_type": "imagetext"}
        cfg.data["train"] = [entry, dict(entry)]
        cfg.data["valid"] = [entry]
        m = dm(cfg, cur_fold=1, data_frac=0.75)
        train, valid = m.batcher("train"), m.batcher("valid")
        if dm is jax_dm.DataModule:
            train.process_index, train.process_count = 0, 1
            valid.process_index, valid.process_count = 0, 1
        train.set_epoch(1)
        batches.append((list(train), list(valid)))
    (t_ours, v_ours), (t_ref, v_ref) = batches
    assert len(t_ours) == len(t_ref) > 0 and len(v_ours) == len(v_ref) > 0
    for a, b in zip(t_ours + v_ours, t_ref + v_ref):
        _batches_equal(a, b)


# ---------------------------------------------------------------- prefetch, logging


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "prefetch_to_device"]


def test_prefetch_to_device_yields_the_batches_and_leaves_no_thread():
    host = [{"images": np.full((2, 4, 4, 1), i, np.uint8),
             "input_ids": np.full((2, 3), i, np.int32)} for i in range(5)]
    got = list(pipeline.prefetch_to_device(iter(host), "cpu", depth=2))
    assert len(got) == 5 and not _prefetch_threads()
    for i, b in enumerate(got):
        assert b["images"].dtype == torch.uint8 and b["input_ids"].dtype == torch.int64
        assert int(b["images"][0, 0, 0, 0]) == i and int(b["input_ids"][1, 2]) == i
    stacked = pipeline.stack_batches(host[:2])
    (one,) = pipeline.prefetch_to_device(iter([stacked]), "cpu", stacked=True)
    assert tuple(one["images"].shape) == (2, 2, 4, 4, 1)

    # dropped after one batch while the worker is blocked on a full queue
    it = pipeline.prefetch_to_device(iter(host), "cpu", depth=1)
    next(it)
    assert _prefetch_threads()
    del it
    assert not _prefetch_threads()


def test_prefetch_propagates_errors_and_stops():
    def bad():
        yield {"x": np.zeros(2, np.float32)}
        raise RuntimeError("boom")

    it = pipeline.prefetch_to_device(bad(), "cpu")
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        next(it)
    assert not _prefetch_threads()


def test_metrics_logger_and_average_meter(tmp_path):
    log = MetricsLogger(str(tmp_path / "w"))
    log.log(3, {"loss/total": 1.5}, prefix="train")
    log.log(3, {"loss/total": 2.0}, prefix="valid")
    log.close()
    rows = [json.loads(line) for line in open(tmp_path / "w" / "metrics.jsonl")]
    assert [(r["step"], r["prefix"], r["loss/total"]) for r in rows] == [
        (3, "train", 1.5), (3, "valid", 2.0)]
    meter = AverageMeter()
    meter.update(2.0, n=3)
    meter.update(6.0)
    assert meter.avg == 3.0
