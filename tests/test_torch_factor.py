"""Mammo-FActOR of the port against the JAX package, on the CPU:
``interpret/factor.py`` (the mapper, the loss, its gradients) and
``cli/factor`` against the JAX CLI on one tiny checkpoint, and fault R10.

The mapper's weights are drawn by the port and carried to JAX with
``convert/from_jax.variables_from_state_dict``. The CLI test runs the port's
CLI on a port checkpoint of a tiny ViT CLIP (its 8x8 patch grid is the
``features`` map: 32 regions of 64 positions), then the JAX CLI on the same
weights (its ``load_clip_for_eval`` handed the JAX model and the carried
tree, its mapper's init the port's initial mapper, its ``save_checkpoint``
recorded): the same rows in the same order, the same losses and the same
trained mapper.

Tolerances (fp32 on both sides): mapper outputs within 1e-4 relative and
absolute, the loss within 1e-5 relative, gradients within 1e-4 relative and
1e-6 absolute; the CLI's losses within 1e-4 relative and its trained mapper
within 1e-6 (a hundredth of the learning rate) after 6 AdamW steps.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mammo_clip_tpu.cli import factor as jax_factor_cli
from mammo_clip_tpu.core.config import Config as JaxConfig
from mammo_clip_tpu.interpret.factor import FactorMapper as JaxMapper
from mammo_clip_tpu.interpret.factor import factor_loss as jax_factor_loss
from mammo_clip_tpu.models import build_model as jax_build_model
from mammo_clip_tpu_torch.cli import factor
from mammo_clip_tpu_torch.convert.from_jax import state_dict_from_jax, variables_from_state_dict
from mammo_clip_tpu_torch.core.config import tiny_test_config
from mammo_clip_tpu_torch.interpret import FactorMapper, factor_loss
from mammo_clip_tpu_torch.models import build_model, init_parameters
from mammo_clip_tpu_torch.train import build_optimizer, create_train_state
from mammo_clip_tpu_torch.train.checkpoint import save_checkpoint

TINY_VIT = {"name": "vit-tiny", "patch_size": 8, "hidden_size": 32, "num_layers": 2,
            "num_heads": 2, "mlp_dim": 64, "base_grid": 4}
BATCH = 4


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
    """Both packages' load_tokenizer give the hashing tokenizer, as on the card."""
    monkeypatch.setitem(__import__("sys").modules, "transformers", None)


def _mapper(**opts):
    m = FactorMapper(num_attributes=2, lang_dim=8, spatial_dim=12, **opts)
    init_parameters(m, torch.Generator().manual_seed(0))
    with torch.no_grad():  # non-zero biases, so that they are held too
        for name, p in m.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    return m


def _features(seed=2, zero_rows=False):
    f = np.random.default_rng(seed).standard_normal((3, 3, 4, 5)).astype(np.float32)
    if zero_rows:
        f[0] = 0.0  # every region of image 0 is an exact zero signature
    return f


@pytest.mark.parametrize("opts", [{}, {"one_proj": True}, {"adapter": True}],
                         ids=["per_attribute", "one_proj", "adapter"])
def test_mapper_matches_jax(opts):
    m = _mapper(**opts)
    n_proj = 1 if opts.get("one_proj") else 2
    assert sorted(n for n, _ in m.named_parameters()) == sorted(
        f"proj{i}_fc{j}.{leaf}" for i in range(n_proj) for j in (1, 2)
        for leaf in ("kernel", "bias"))
    f = _features()
    want = JaxMapper(num_attributes=2, lang_dim=8, spatial_dim=12, **opts).apply(
        variables_from_state_dict(m.state_dict()), jnp.asarray(f))
    with torch.no_grad():
        got = m(torch.from_numpy(f))
    assert got.shape == (3, 5, 2, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="spatial_dim"):
        m(torch.zeros(1, 4, 4, 5))


def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    attr = rng.standard_normal((2, 8)).astype(np.float32)
    attr /= np.linalg.norm(attr, axis=1, keepdims=True)
    labels = np.array([[1, 0], [0, 0], [1, 0]], np.float32)  # attribute 1 absent
    return attr, labels


@pytest.mark.parametrize("zero_rows", [False, True], ids=["regions", "zero_regions"])
def test_mapper_and_loss_gradients_match_jax(zero_rows):
    """The loss and its gradients in the mapper's parameters and in the
    features. With ``zero_regions`` image 0's regions are exact zeros and the
    mapper's biases zero, so its region embeddings are exact zero rows, where
    the safe normalize keeps every gradient finite and the max's ties share
    the gradient as JAX's do."""
    m = _mapper()
    if zero_rows:
        with torch.no_grad():
            for name, p in m.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
    f = _features(zero_rows=zero_rows)
    attr, labels = _loss_inputs(3)
    jm = JaxMapper(num_attributes=2, lang_dim=8, spatial_dim=12)

    def jloss(params, feats):
        return jax_factor_loss(jm.apply({"params": params}, feats), jnp.asarray(attr),
                               jnp.asarray(labels))

    v = variables_from_state_dict(m.state_dict())
    want, (gp, gf) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(v["params"],
                                                                         jnp.asarray(f))
    ft = torch.from_numpy(f).requires_grad_(True)
    loss = factor_loss(m(ft), torch.from_numpy(attr), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    grads = {n: p.grad for n, p in m.named_parameters()}
    for k, w in state_dict_from_jax({"params": gp}).items():
        assert torch.isfinite(grads[k]).all(), k
        np.testing.assert_allclose(grads[k].numpy(), w.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
    assert torch.isfinite(ft.grad).all()
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(gf), rtol=1e-4, atol=1e-6)


def test_loss_at_exact_zero_rows_matches_jax():
    """Region embeddings given directly, image 0's all exactly zero (the JAX
    package's test_factor_loss_grads_finite_at_zero_regions case)."""
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((3, 5, 2, 8)).astype(np.float32)
    emb[0] = 0.0
    attr, labels = _loss_inputs(5)
    labels[1, 1] = 1.0  # both attributes present
    want, g = jax.value_and_grad(lambda e: jax_factor_loss(e, jnp.asarray(attr),
                                                           jnp.asarray(labels)))(jnp.asarray(emb))
    et = torch.from_numpy(emb).requires_grad_(True)
    loss = factor_loss(et, torch.from_numpy(attr), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    assert torch.isfinite(et.grad).all()
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-6)


# --------------------------------------------------------------------------- cli/factor


def _write_csv(path, n_pos, n_neg=4):
    """n_pos rows positive for Mass or calcification in the train split (fold 1),
    n_neg negative rows (dropped by the CLI) and 2 validation rows (fold 0)."""
    import csv

    rows = [{"patient_id": f"p{i}", "image_id": f"im{i}.png", "Mass": int(i % 3 != 1),
             "Suspicious_Calcification": int(i % 3 != 0), "fold": 1} for i in range(n_pos)]
    rows += [{"patient_id": f"n{i}", "image_id": f"neg{i}.png", "Mass": 0,
              "Suspicious_Calcification": 0, "fold": 1} for i in range(n_neg)]
    rows += [{"patient_id": f"v{i}", "image_id": f"val{i}.png", "Mass": 1,
              "Suspicious_Calcification": 0, "fold": 0} for i in range(2)]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return str(path)


@pytest.fixture(scope="module")
def clip_ckpt(tmp_path_factory):
    """A port checkpoint of a tiny ViT CLIP, and the JAX model and tree of the
    same weights with the same config."""
    cfg = tiny_test_config()
    cfg.model.image_encoder = dict(TINY_VIT)
    model = build_model(cfg.model.to_dict(), device="cpu",
                        generator=torch.Generator().manual_seed(6))
    opt = build_optimizer(cfg.optimizer.to_dict(), lambda s: 1e-4, model.named_parameters())
    root = tmp_path_factory.mktemp("clip")
    save_checkpoint(str(root / "best"), create_train_state(model, opt), config=cfg.to_dict(),
                    step=1)
    jcfg = JaxConfig(cfg.to_dict())
    jax_model = jax_build_model(jcfg.model.to_dict())
    return str(root / "best"), root, (jax_model, variables_from_state_dict(model.state_dict()),
                                      jcfg)


def _run_both(clip_ckpt, csv_path, work, monkeypatch, capsys, epochs="2"):
    """The port's CLI, then the JAX CLI seeded with the port's initial mapper.
    Returns (port result or exception, port initial and trained mapper, port
    stdout, the JAX CLI's saved state and meta, its stdout)."""
    ckpt, _, jax_clip = clip_ckpt
    flags = ["--clip-checkpoint", ckpt, "--csv", csv_path, "--image-dir", "synthetic://",
             "--epochs", epochs, "--batch-size", str(BATCH)]
    inits = []
    init0 = factor.init_parameters

    def recorded_init(module, generator):
        init0(module, generator)
        inits.append({k: v.detach().clone() for k, v in module.state_dict().items()})

    monkeypatch.setattr(factor, "init_parameters", recorded_init)
    try:
        port = factor.main(flags + ["--device", "cpu", "--workdir", str(work / "port")])
    except ValueError as e:
        port = e
    port_out = capsys.readouterr().out

    saved = []

    class SeededMapper(JaxMapper):
        def init(self, *args, **kwargs):  # the JAX init where the port built no mapper
            return variables_from_state_dict(inits[0]) if inits else \
                JaxMapper.init(self, *args, **kwargs)

    monkeypatch.setattr(jax_factor_cli, "enable_compile_cache", lambda: None)
    monkeypatch.setattr(jax_factor_cli, "load_clip_for_eval", lambda path: jax_clip)
    monkeypatch.setattr(jax_factor_cli, "FactorMapper", SeededMapper)
    monkeypatch.setattr(jax_factor_cli, "save_checkpoint",
                        lambda path, state, config, extra_meta, max_to_keep:
                        saved.append((jax.tree_util.tree_map(np.asarray, state.params),
                                      extra_meta)))
    jax_factor_cli.main(flags + ["--workdir", str(work / "jax")])
    return port, inits, port_out, saved, capsys.readouterr().out


def test_factor_cli_matches_jax(clip_ckpt, tmp_path, monkeypatch, capsys):
    """12 positive train rows at batch 4: 3 steps an epoch, 2 epochs."""
    csv_path = _write_csv(tmp_path / "factor.csv", n_pos=12)
    port, inits, port_out, saved, jax_out = _run_both(clip_ckpt, csv_path, tmp_path,
                                                      monkeypatch, capsys)
    assert len(inits) == 1 and len(saved) == 1
    params, meta = saved[0]
    assert math.isfinite(port["final_loss"]) and math.isfinite(meta["final_loss"])
    np.testing.assert_allclose(port["final_loss"], meta["final_loss"], rtol=1e-4)
    assert json.loads(port_out.strip().splitlines()[-1]) == port
    epochs = lambda out: [float(line.split("loss=")[1]) for line in out.splitlines()
                          if line.startswith("epoch ")]
    np.testing.assert_allclose(epochs(port_out), epochs(jax_out), rtol=1e-3, atol=1e-4)
    assert len(epochs(port_out)) == 2
    # the mapper: per-attribute MLPs over the 8x8 grid (64 positions) into the 32-d space
    mapper_dir = tmp_path / "port" / "mapper"
    step_dir = mapper_dir / os.listdir(mapper_dir)[0]
    payload = torch.load(step_dir / "state.pt", weights_only=True)
    meta_port = json.loads((step_dir / "meta.json").read_text())
    assert payload["step"] == 6 and meta_port["final_loss"] == port["final_loss"]
    assert json.loads((step_dir / "config.json").read_text())["attributes"] == \
        ["Mass", "Suspicious_Calcification"]
    trained = payload["model"]
    assert trained["proj0_fc1.kernel"].shape == (64, 64)
    assert trained["proj1_fc2.kernel"].shape == (64, 32)
    want = state_dict_from_jax({"params": params})
    assert set(want) == set(trained)
    for k, w in want.items():
        assert not torch.equal(trained[k], inits[0][k]), k  # trained
        np.testing.assert_allclose(trained[k].numpy(), w.numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_r10_jax_cli_saves_an_untrained_mapper_the_port_refuses(clip_ckpt, tmp_path,
                                                                monkeypatch, capsys):
    """Fault R10: 3 positive train rows at batch 4. The JAX CLI's loop
    ``range(0, len(order) - bs + 1, bs)`` takes no step, and it saves its
    freshly initialised mapper with final_loss NaN; the port raises before
    loading anything and writes nothing."""
    csv_path = _write_csv(tmp_path / "few.csv", n_pos=3)
    port, inits, port_out, saved, jax_out = _run_both(clip_ckpt, csv_path, tmp_path,
                                                      monkeypatch, capsys, epochs="1")
    assert isinstance(port, ValueError) and "fewer than --batch-size 4" in str(port)
    assert not inits and not (tmp_path / "port").exists()
    (params, meta), = saved
    assert math.isnan(meta["final_loss"])
    assert math.isnan(json.loads(jax_out.strip().splitlines()[-1])["final_loss"])
    assert "epoch 1: loss=nan" in jax_out
    fresh = JaxMapper(num_attributes=2, lang_dim=32, spatial_dim=64).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 32)))["params"]
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(fresh)):
        np.testing.assert_array_equal(a, np.asarray(b))  # untrained
