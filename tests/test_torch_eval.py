"""The port's evaluation layer (``mammo_clip_tpu_torch/eval/``) on the CPU against
the JAX package and scikit-learn.

* metrics: ``auroc`` / ``auprc`` / ``pr_auc`` / ``accuracy`` equal to sklearn's
  ``roc_auc_score`` / ``average_precision_score`` / ``auc(precision_recall_curve)``
  / ``accuracy_score`` within 1e-12 (seeded scores, with ties, with one class
  present), and the same exception type where sklearn raises; ``pfbeta`` and
  ``pfbeta_binarized`` equal to the JAX package's exactly;
* retrieval: equal to the JAX package's exactly, with duplicate texts and tied
  similarities;
* zero-shot: equal to the JAX package's on the same embeddings within 1e-12;
* the embedding extractor: equal to the JAX package's on a JAX-initialised
  tiny CLIP carried over with ``convert/from_jax.py`` (N = 5 at batch 2, uint8
  and float images) within rtol 1e-4 / atol 1e-5 (fp32, another summation
  order, as tests/test_torch_models.py);
* loading: a port checkpoint directory with and without its EMA, and the EMA
  requested where there is none.
"""

import warnings

import jax
import numpy as np
import pytest
import torch
from sklearn import metrics as skm

from mammo_clip_tpu.core.config import tiny_test_config as jax_tiny_config
from mammo_clip_tpu.eval import metrics as jax_metrics
from mammo_clip_tpu.eval import zeroshot as jax_zeroshot
from mammo_clip_tpu.eval.embeddings import EmbeddingExtractor as JaxExtractor
from mammo_clip_tpu.eval.retrieval import eval_image_text_retrieval as jax_retrieval
from mammo_clip_tpu.models import build_model as jax_build_model
from mammo_clip_tpu_torch.convert.from_jax import load_jax_variables
from mammo_clip_tpu_torch.core.config import tiny_test_config
from mammo_clip_tpu_torch.eval import metrics, zeroshot
from mammo_clip_tpu_torch.eval.embeddings import EmbeddingExtractor
from mammo_clip_tpu_torch.eval.loading import load_clip_for_eval
from mammo_clip_tpu_torch.eval.retrieval import eval_image_text_retrieval
from mammo_clip_tpu_torch.models import build_model
from mammo_clip_tpu_torch.train import build_optimizer, create_train_state
from mammo_clip_tpu_torch.train.checkpoint import save_checkpoint
from mammo_clip_tpu_torch.train.schedule import warmup_cosine_sq_schedule


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """1 intra-op thread: the suite runs its files in parallel
    processes, and torch's default of one thread per core in each oversubscribes
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _sk_pr_auc(gt, pred):
    precision, recall, _ = skm.precision_recall_curve(gt, pred)
    return skm.auc(recall, precision)


SCORES = [(metrics.auroc, skm.roc_auc_score), (metrics.auprc, skm.average_precision_score),
          (metrics.pr_auc, _sk_pr_auc)]


def _labels_scores(seed, kind):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 60))
    gt = rng.integers(0, 2, n)
    pred = rng.random(n)
    if kind == "ties":
        pred = np.round(pred, 1)  # ~10 distinct scores: many ties across classes
    elif kind == "one_negative":
        gt[:] = 0
    elif kind == "one_positive":
        gt[:] = 1
    return gt, pred


@pytest.mark.parametrize("kind", ["plain", "ties", "one_negative", "one_positive"])
@pytest.mark.parametrize("seed", range(4))
def test_metrics_equal_sklearn(seed, kind):
    gt, pred = _labels_scores(seed, kind)
    for ours, theirs in SCORES:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # one class present: both warn
            want, got = theirs(gt, pred), ours(gt, pred)
        if np.isnan(want):
            assert np.isnan(got), ours.__name__
        else:
            assert abs(got - want) <= 1e-12, (ours.__name__, got, want)
    labels = (pred > 0.5).astype(int)
    assert metrics.accuracy(gt, labels) == pytest.approx(skm.accuracy_score(gt, labels),
                                                         abs=1e-12)
    assert metrics.pfbeta(gt, pred) == jax_metrics.pfbeta(gt, pred)
    assert metrics.pfbeta(gt, pred, 2.0) == jax_metrics.pfbeta(gt, pred, 2.0)
    assert metrics.pfbeta_binarized(gt, pred) == jax_metrics.pfbeta_binarized(gt, pred)


@pytest.mark.parametrize("case", ["three_classes", "lengths", "nan_score", "labels_1_2",
                                  "labels_0_2", "one_point"])
def test_metrics_raise_where_sklearn_raises(case):
    gt, pred = np.array([0, 1, 1, 0, 1]), np.array([0.1, 0.8, 0.4, 0.4, 0.9])
    if case == "three_classes":
        gt = np.array([0, 1, 2, 0, 1])
    elif case == "lengths":
        pred = pred[:4]
    elif case == "nan_score":
        pred = np.array([0.1, np.nan, 0.4, 0.4, 0.9])
    elif case == "labels_1_2":
        gt = gt + 1
    elif case == "labels_0_2":
        gt = 2 * gt
    elif case == "one_point":
        gt, pred = gt[:1], pred[:1]
    for ours, theirs in SCORES:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                want = theirs(gt, pred)
            except ValueError:
                with pytest.raises(ValueError):
                    ours(gt, pred)
                continue
            got = ours(gt, pred)
        assert (np.isnan(got) and np.isnan(want)) or abs(got - want) <= 1e-12, \
            (case, ours.__name__, got, want)
    with pytest.raises(ValueError):
        skm.accuracy_score([0, 1, 1], [0, 1])
    with pytest.raises(ValueError):
        metrics.accuracy([0, 1, 1], [0, 1])


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_retrieval_equals_jax_with_duplicates_and_ties():
    rng = np.random.default_rng(1)
    img = _unit(rng.standard_normal((24, 8)))
    img[5] = img[4]  # tied rows
    txt = _unit(rng.standard_normal((24, 8)))
    txt[9] = txt[3]  # a different text with the same embedding: tied similarities
    texts = [f"report {i % 17}" for i in range(24)]  # repeats
    want = jax_retrieval(img, txt, texts)
    assert eval_image_text_retrieval(img, txt, texts) == want
    ks = (1, 2, 3)
    assert eval_image_text_retrieval(img, txt, texts, ks) == jax_retrieval(img, txt, texts, ks)


class _PromptTable:
    """A tokenizer and an extractor over fixed prompt embeddings: the token id
    of a prompt is its index in the table."""

    def __init__(self, prompts, dim, seed):
        self.index = {p: i for i, p in enumerate(prompts)}
        self.emb = _unit(np.random.default_rng(seed).standard_normal((len(prompts), dim)))

    def __call__(self, texts, max_length=256):
        ids = np.array([[self.index[t]] for t in texts])
        return {"input_ids": ids, "attention_mask": np.ones_like(ids)}

    def encode_texts(self, input_ids, attention_mask):
        return self.emb[input_ids[:, 0]]


def test_zeroshot_equals_jax():
    assert zeroshot.DEFAULT_ZS_PROMPTS == jax_zeroshot.DEFAULT_ZS_PROMPTS
    assert zeroshot._LABEL_KEY == jax_zeroshot._LABEL_KEY
    prompts = {"mass": ["no mass", "mass"],
               "suspicious_calcification": ["no calc", "calc"],
               "density": ["a", "b", "c", "d"], "not_a_label": ["x", "y"]}
    table = _PromptTable([p for v in prompts.values() for p in v], 8, seed=2)
    rng = np.random.default_rng(3)
    img = _unit(rng.standard_normal((30, 8)))
    labels = {"mass": rng.integers(0, 2, 30), "calc": rng.integers(0, 2, 30),
              "density": rng.integers(0, 4, 30)}
    got = zeroshot.eval_zeroshot(table, table, img, labels, prompts)
    want = jax_zeroshot.eval_zeroshot(table, table, img, labels, prompts)
    assert set(got) == set(want) == {"mass", "suspicious_calcification", "density"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k
    one_class = dict(labels, mass=np.zeros(30, int))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert np.isnan(zeroshot.eval_zeroshot(table, table, img, one_class, prompts)["mass"])
        assert np.isnan(jax_zeroshot.eval_zeroshot(table, table, img, one_class, prompts)["mass"])


@pytest.fixture(scope="module")
def tiny_clip():
    """A JAX-initialised tiny CLIP, and the port's model carrying its weights."""
    jcfg = jax_tiny_config()
    jm = jax_build_model(jcfg.model.to_dict())
    h, w, s = jcfg.data.image_size_h, jcfg.data.image_size_w, jcfg.data.text_max_length
    example = {"images": np.zeros((2, h, w, 1), np.float32),
               "input_ids": np.ones((2, s), np.int32), "attention_mask": np.ones((2, s), np.int32)}
    variables = jax.jit(lambda b: jm.init({"params": jax.random.PRNGKey(0)}, b, train=False))(example)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    cfg = tiny_test_config()
    model = build_model(cfg.model.to_dict(), device="cpu")
    load_jax_variables(model, variables)
    return jm, variables, model, cfg


def test_extractor_matches_jax(tiny_clip):
    jm, variables, model, cfg = tiny_clip
    mean, std = cfg.data.mean, cfg.data.std
    theirs = JaxExtractor(jm, variables, mean, std, batch_size=2)
    ours = EmbeddingExtractor(model, mean, std, batch_size=2)
    rng = np.random.default_rng(4)
    h, w, s = cfg.data.image_size_h, cfg.data.image_size_w, cfg.data.text_max_length
    images = rng.integers(0, 256, (5, h, w, 1)).astype(np.uint8)
    for x in (images, images.astype(np.float32) / 7.0):
        got, want = ours.encode_images(x), theirs.encode_images(x)
        assert got.dtype == np.float32 and got.shape == want.shape == (5, 32)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    lengths = rng.integers(2, s + 1, 5)
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    ids = rng.integers(4, cfg.model.text_encoder.vocab_size, (5, s)).astype(np.int32) * mask
    np.testing.assert_allclose(ours.encode_texts(ids, mask), theirs.encode_texts(ids, mask),
                               rtol=1e-4, atol=1e-5)

    batches = [{"images": images[:3], "input_ids": ids[:3], "attention_mask": mask[:3],
                "texts": ["a", "b", "c"], "mass": np.array([0, 1, 1])},
               {"images": images[3:], "input_ids": ids[3:], "attention_mask": mask[3:],
                "texts": ["d", "e"], "mass": np.array([1, 0])}]
    got = ours.run_dataset(batches, label_keys=("mass", "calc"))
    want = theirs.run_dataset(batches, label_keys=("mass", "calc"))
    assert set(got) == set(want) == {"image_embeddings", "text_embeddings", "texts", "mass"}
    assert got["texts"] == want["texts"]
    np.testing.assert_array_equal(got["mass"], want["mass"])
    for k in ("image_embeddings", "text_embeddings"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", ["raw", "ema", "ema_absent"])
def test_load_clip_for_eval_from_a_port_checkpoint(tiny_clip, tmp_path, case):
    _, _, model, cfg = tiny_clip
    opt = build_optimizer(cfg.optimizer.to_dict(), warmup_cosine_sq_schedule(1e-4, 10, 1),
                          model.named_parameters())
    state = create_train_state(model, opt, ema_decay=0.0 if case == "ema_absent" else 0.9)
    if state.ema is not None:
        for v in state.ema.values():
            v.add_(1.0)  # EMA weights that differ from the raw ones
    run = tmp_path / "run"
    save_checkpoint(str(run / "checkpoints"), state, config=cfg.to_dict(), step=3)
    save_checkpoint(str(run / "best"), state, config=cfg.to_dict(), step=3)
    if case == "ema_absent":
        with pytest.raises(ValueError, match="no EMA"):
            load_clip_for_eval(str(run), use_ema=True, device="cpu")
        return
    for path in (str(run), str(run / "best")):
        loaded, loaded_cfg = load_clip_for_eval(path, use_ema=case == "ema", device="cpu")
        assert loaded_cfg.to_dict() == cfg.to_dict() and not loaded.training
        params = dict(loaded.named_parameters())
        for name, p in model.named_parameters():
            want = state.ema[name] if case == "ema" else p
            assert torch.equal(params[name], want), name
        for name, b in model.named_buffers():
            assert torch.equal(dict(loaded.named_buffers())[name], b), name


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; tests/test_torch_cuda.py covers a missing index")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_clip_for_eval(str(tmp_path), device="cuda")
