"""``correct`` comes out false when the timed path is broken underneath, and
when the control (the reference in the precision below the configuration's)
stands in the program's place, each judged by the cell's own limits.

Each fault drives the rest of a run (set-up, the checked steps or batches,
a short window, the reference, the comparison) on the CPU at tiny sizes,
with the chip's look left out: a step that returns its state unchanged,
half of every batch left out with the loss's mean over the rest, an answer
altered where it is produced.
"""

import time

import numpy as np
import pytest
import torch

from portbench.harness import compare

from .test_bench_card import CONTROL


def run(cell):
    return cell.loop().run(cell, 987654321012, 0.2, False, time.perf_counter(), device="cpu")


@pytest.fixture
def broken_step(monkeypatch):
    """broken_step(fault): the recipe's step replaced by a faulty one."""
    from mammo_clip_tpu_torch.train import recipes

    real = recipes.build_bench_train

    def install(fault):
        def build(*args, **kwargs):
            model, loss_fn, state, preprocess, step = real(*args, **kwargs)

            def unchanged(state, batch, generator, seed=None):
                with torch.no_grad():
                    out = model(preprocess(batch, generator), train=True, generator=generator)
                return state, loss_fn(out, batch, True)

            def half(state, batch, generator, seed=None):
                rows = batch["images"].shape[0] // 2
                return step(state, {k: v[:rows] for k, v in batch.items()}, generator, seed)

            return model, loss_fn, state, preprocess, {"unchanged": unchanged, "half": half}[fault]

        monkeypatch.setattr(recipes, "build_bench_train", build)

    return install


@pytest.mark.parametrize("workload", ["b5_pretrain_b8", "vit_pretrain_b8"])
@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_training_fault_is_not_correct(tiny_cell, broken_step, workload, fault):
    broken_step(fault)
    outcome = run(tiny_cell(workload))
    assert not compare.passed(outcome.checks)


def test_altered_answer_is_not_correct(tiny_cell, monkeypatch):
    from mammo_clip_tpu_torch.eval.embeddings import EmbeddingExtractor

    real = EmbeddingExtractor.encode_images

    def altered(self, images):
        out = real(self, images)
        out[0] = out[1]
        return out

    monkeypatch.setattr(EmbeddingExtractor, "encode_images", altered)
    outcome = run(tiny_cell("b5_embed_b16"))
    assert outcome.checks["image_gap"]["value"] > outcome.checks["image_gap"]["limit"]


@pytest.mark.parametrize("workload", sorted(CONTROL))
def test_control_is_not_correct(tiny_cell, workload):
    control = CONTROL[workload]
    cell = tiny_cell(workload)
    readings = cell.loop().readings(cell, 20240613, "cpu", (control,))
    assert not compare.passed(compare.judge(readings[control], cell.limits))


def test_the_sound_path_gives_the_same_answers_each_time(tiny_cell):
    """Answers due in the window repeat for the same input (no state leaks
    across batches in eval mode)."""
    from portbench.loops import embed

    cell = tiny_cell("b5_embed_b16")
    extractor, _, pool = embed.start(cell, 5, "cpu")
    a = embed.embed_batch(extractor, pool[0])
    b = embed.embed_batch(extractor, pool[0])
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
