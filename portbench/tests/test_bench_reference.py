"""The plain reference against the program's CPU path at tiny sizes, in fp32:
the same names and shapes, the same first steps (draws, augmentation,
towers, loss, AdamW), the same embeddings."""

import itertools

import numpy as np
import pytest
import torch

from portbench.loops import pretrain
from portbench.harness import compare, inputs
from portbench.reference import clip as ref

SEED = 4242


def program_step(cfg):
    """The bench recipe's step, built as ``build_bench_train`` builds it but
    with fp32 activations (the recipe's are bf16)."""
    from mammo_clip_tpu_torch.losses import build_loss
    from mammo_clip_tpu_torch.models import build_model
    from mammo_clip_tpu_torch.ops.augment import AugmentConfig, augment_two_views
    from mammo_clip_tpu_torch.train import (build_optimizer, create_train_state,
                                            make_train_step, warmup_cosine_sq_schedule)
    from mammo_clip_tpu_torch.train.recipes import bench_recipe_config

    c = bench_recipe_config(**cfg["recipe"]).merged(cfg["config"])
    model = build_model(c.model.to_dict(), dtype=torch.float32, device="cpu")
    sched = warmup_cosine_sq_schedule(c.optimizer.lr, cfg["schedule"]["total_steps"],
                                      cfg["schedule"]["warmup_steps"])
    state = create_train_state(model, build_optimizer(c.optimizer.to_dict(), sched,
                                                      model.named_parameters()))
    aug = AugmentConfig.from_dict(c.augment.to_dict())

    def preprocess(batch, g):
        batch = dict(batch)
        batch["images"], batch["image_views"] = augment_two_views(
            batch["images"], batch["image_views"], g, aug, c.data.mean, c.data.std)
        return batch

    return model, state, make_train_step(model, build_loss(c.loss.to_dict()), preprocess)


@pytest.mark.parametrize("workload", ["b5_pretrain_b8", "vit_pretrain_b8"])
def test_training_steps_match_the_program(tiny_cell, workload):
    from mammo_clip_tpu_torch.data.pipeline import prefetch_to_device

    cell = tiny_cell(workload)
    cfg = cell.config
    model, state, step = program_step(cfg)
    params, buffers = ref.param_shapes(cfg["config"]["model"])
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {**params, **buffers}
    weights = inputs.make_weights(params, buffers, SEED, "cpu")
    model.load_state_dict(weights, strict=True)
    pool = inputs.host_batches(cell.traffic, cfg["config"], SEED)
    feed = prefetch_to_device(itertools.cycle(pool), "cpu", depth=2)
    gen = torch.Generator()
    prog = pretrain.checked_steps(model, state, feed, lambda b: step(state, b, gen, seed=SEED),
                                  cell.traffic["checked_steps"], 0.9)
    feed.close()
    out = pretrain.reference(cell, weights, pool, SEED, "cpu")
    gaps = compare.training_gaps(prog, out)
    # fp32 on both sides: only the order of sums differs (Adam's step divides
    # by sqrt(v), which magnifies the relative noise of small gradients)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-3
    assert gaps["image_gap"] < 1e-5 and gaps["text_gap"] < 1e-5


def test_embeddings_match_the_extractor(tiny_cell):
    from portbench.loops import embed

    cell = tiny_cell("b5_embed_b16")
    extractor, weights, pool = embed.start(cell, SEED, "cpu")
    answers = [(i, *embed.embed_batch(extractor, b)) for i, b in enumerate(pool)]
    gaps = embed.gaps(answers, embed.reference(cell, weights, pool, "cpu"))
    assert gaps["image_gap"] < 1e-4 and gaps["text_gap"] < 1e-5
    # calibrated running statistics: eval-mode features are not degenerate
    img = answers[0][1]
    assert np.isfinite(img).all() and np.abs(img - img[:1]).max() > 1e-3


def test_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path

    for path in Path(ref.__file__).parent.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0].startswith("mammo_clip_tpu") for n in names), path
