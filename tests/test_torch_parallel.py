"""Data and tensor parallelism of the port (``core/mesh.py``, ``parallel/``)
against one process and against the JAX package's meshes.

Four gloo CPU ranks are spawned once for the file
(``parallel/dryrun.py::run_ranks``, with a timeout on the spawn, about twice
what the file's ranks take, and on ``init_process_group``); each runs
``tests/torch_parallel_ranks.py::parity`` and returns its numbers here, while
this process computes the JAX side on the conftest's virtual CPU devices and
the port's one-process steps. What the ranks run:

* the tiny CLIP (b0 at 64x64, 2-layer BERT, fp32, fused route on: its plain
  version with the cross-rank hook) at 2 rows a rank, from the JAX package's
  initial variables (``convert/from_jax.py``), augmentation, dropout and
  drop-connect off: one step, and one K=2 call from the same state. Held to
  the port's one-process step on the global batch of 8 (loss 1e-5 relative,
  parameters and EMA 1e-6 absolute, BatchNorm running statistics 1e-4, the
  averaged gradients 1e-4 per tensor with a least-squares scale of 1 to 1e-4:
  ``dryrun.compare``), and the step to the JAX step on a 4-device data mesh
  (``MeshContext.create(data=4)`` with ``shard_train_state``; JAX on its Flax
  route) at ``tests/test_torch_train.py``'s tolerances (losses 1e-4 relative
  and 1e-5 absolute, parameters 1e-5, BatchNorm statistics 1e-4), AdamW's eps
  at 1e-3 as there;
* ``gathered_clip_loss`` on its rows of 8 embeddings, against
  ``shard_map_clip_loss`` on a 4-device JAX mesh (and the single-pair loss
  against JAX's over the global batch): the loss terms (1e-6) and
  the gradients with respect to each rank's rows (1e-6 after the division by
  the 4 ranks: each rank differentiates its own term, whose gathered
  cotangents sum over the ranks, and the ranks' parameter gradients are
  averaged after the backward);
* the fused block's plain version in both forms on a 2-rank group, against
  the whole-batch call (out, stats, dx and the ranks' summed parameter
  gradients, 1e-5);
* the augmentation and drop-connect draws of each rank's step 0;
* then laid out as (data 2, model 2), on the first 4 rows: the same step and
  K=2 call with the state placed by ``shard_train_state(fsdp=True)`` (BERT's
  heads and FFN and the eligible MBConv blocks split over ``model``, the
  large leaves left ZeRO-3 over ``data``), and with whole parameters (2 data
  ranks, each model group's ranks replicas: fault 3.5's layout), both held
  to the port's one-process step on those 4 rows (``dryrun.compare``), to
  JAX's TP + FSDP step on a (2, 2) mesh (``shard_train_state(..., fsdp=True)``
  and ``make_train_step``, as ``tests/test_parallel.py`` builds it) and to
  JAX's two steps on a 2-device data mesh: loss and post-update |params|
  within JAX's own 1e-4 (``__graft_entry__.py:192-196``), the K=2 call
  against JAX's second step; the draws of the ranks of a model group; and a
  TP + FSDP checkpoint written by rank 0 and restored;
* on the same layout and rows, the TP + FSDP step with
  ``text_encoder.seq_parallel`` (BERT's LayerNorm and residual regions on
  sequence shards over ``model``): held to the one process as above, to the
  TP step's loss, and to JAX's ``seq_parallel`` step on a (2, 2) mesh under
  ``jax.set_mesh`` at ``tests/test_parallel.py``'s tolerances (loss 2e-5
  relative; parameters 5e-4 relative and 1e-5 absolute), the batch
  replicated there (with it split over ``data``, R13 below doubles blocks 0
  and 1's depthwise gradients, and the clip spreads that over every tensor
  at ~1.2e-5);
* the tiny pipeline BERT of ``tests/test_pipeline.py`` (4 layers, hidden 16)
  over 4 stages, one a rank, point-to-point over gloo (``dryrun.pp_case``):
  held to the port's sequential tower (``dryrun.compare_pp``: hidden
  states 1e-4, every gradient 1e-4 relative) and to JAX's
  ``pipelined_bert_hidden`` on a 4-device pipe mesh (2e-5).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import mammo_clip_tpu.models.clip as jax_clip
from mammo_clip_tpu.core.config import tiny_test_config as jax_tiny_config
from mammo_clip_tpu.core.mesh import MeshContext as JaxMeshContext
from mammo_clip_tpu.data.pipeline import Batcher as JaxBatcher
from mammo_clip_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from mammo_clip_tpu.losses import build_loss as jax_build_loss
from mammo_clip_tpu.losses import contrastive_clip_loss as jax_contrastive_clip_loss
from mammo_clip_tpu.models import build_model as jax_build_model
from mammo_clip_tpu.ops import augment as jax_aug
from mammo_clip_tpu.parallel import shard_train_state
from mammo_clip_tpu.parallel.shard_loss import shard_map_clip_loss
from mammo_clip_tpu.train import build_optimizer as jax_build_optimizer
from mammo_clip_tpu.train import create_train_state as jax_create_train_state
from mammo_clip_tpu.train import make_train_step as jax_make_train_step
from mammo_clip_tpu.train import warmup_cosine_sq_schedule as jax_schedule
from mammo_clip_tpu_torch.convert.from_jax import state_dict_from_jax
from mammo_clip_tpu_torch.core import mesh
from mammo_clip_tpu_torch.data.pipeline import Batcher
from mammo_clip_tpu_torch.data.tokenizer import HashTokenizer
from mammo_clip_tpu_torch.ops.mbconv import MBConvParams, _bn, batch_stats
from mammo_clip_tpu_torch.ops.mbconv6 import MBConv6Params, plain_fused_mbconv_e6
from mammo_clip_tpu_torch.parallel import dryrun
from mammo_clip_tpu_torch.train.step import step_seed

RANKS, B, SEED = 4, 2, 0
RANKS_TIMEOUT_S = 300.0  # about twice what the file takes under the suite's load
WORKERS = str(Path(__file__).with_name("torch_parallel_ranks.py"))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """1 intra-op thread: the suite runs its files in parallel processes, and
    torch's default of one thread per core in each oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _norm(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _fused_cases():
    """A small e6 case (with a pad region) and an e=1 case with its residual,
    4 images each: the inputs, parameters and output weights as numpy."""
    rng = np.random.default_rng(5)
    f = lambda *s: (0.5 * rng.standard_normal(s)).astype(np.float32)
    cases = {}
    for form, (c, e, c2, h, w, vh, vw) in {"e6": (8, 48, 8, 16, 16, 13, 11),
                                            "e1": (8, 8, 8, 16, 16, 16, 16)}.items():
        x = np.zeros((4, c, h, w), np.float32)
        x[:, :, :vh, :vw] = f(4, c, vh, vw)
        common = dict(dw_kernel=f(e, 3, 3), gamma1=1 + 0.1 * f(e), beta1=0.1 * f(e),
                      se_w1=f(e, 2), se_b1=0.1 * f(2), se_w2=f(2, e), se_b2=0.1 * f(e),
                      wp=f(e, c2) / np.sqrt(e), gamma2=1 + 0.1 * f(c2), beta2=0.1 * f(c2))
        if form == "e6":
            common.update(we=f(c, e) / np.sqrt(c), gamma0=1 + 0.1 * f(e), beta0=0.1 * f(e))
        common = {k: v.astype(np.float32) for k, v in common.items()}
        cases[form] = {"x": x, "params": common, "delta": np.array([1.25, 0, 1.25, 1], np.float32),
                       "w": f(4, c2, h, w), "vh": vh, "vw": vw}
    return cases


def _jax_cfg():
    cfg = jax_tiny_config()
    cfg.model.image_encoder.drop_connect_rate = 0.0
    cfg.optimizer.update(lr=1e-3, eps=1e-3, grad_clip_norm=1.0)
    return cfg


def _embeddings():
    rng = np.random.default_rng(11)
    return {k: _norm(rng.standard_normal((RANKS * B, 16))).astype(np.float32)
            for k in ("i1", "t1", "i2", "t2")}


class _NoDropout:
    """The JAX BERT without dropout (its config ignores the port's knob)."""

    def __enter__(self):
        self.orig = orig = jax_clip.bert_config_from_model_config
        jax_clip.bert_config_from_model_config = lambda mc: dataclasses.replace(
            orig(mc), dropout_rate=0.0)

    def __exit__(self, *exc):
        jax_clip.bert_config_from_model_config = self.orig


def _jax_state(host, data=RANKS, model=1):
    """The JAX package's tiny CLIP, its train state on a (data, model) mesh of
    the conftest's devices and the step's pieces."""
    cfg = _jax_cfg()
    with _NoDropout():
        net = jax_build_model(cfg.model.to_dict())
    tx = jax_build_optimizer(cfg.optimizer.to_dict(), jax_schedule(1e-3, 100, 0))
    ctx = JaxMeshContext.create(data=data, model=model, devices=jax.devices()[:data * model])
    batch = ctx.shard_host_batch(host[0])
    state = jax_create_train_state(net, batch, tx, jax.random.PRNGKey(0), ema_decay=0.9)
    return cfg, net, ctx, batch, state


def _jax_steps(cfg, model, ctx, batch, state, fsdp=False, second=None, restart=None):
    """One JAX step (Flax route) on the mesh, the state placed by
    ``shard_train_state`` (with ``fsdp``: JAX's TP + ZeRO-3 placement): its
    losses, the state after it (as numpy) and that state; with ``second`` (a
    host batch) also the losses and the post-update |params| of a second step
    on it, taken from the state after this step or from ``restart`` (another
    mesh's state after its first step, placed on this mesh)."""
    import optax

    mean, std = cfg.data.mean, cfg.data.std

    def normalize(b, rng):
        b = dict(b)
        for k in ("images", "image_views"):
            b[k] = jax_aug.minmax_standardize(b[k], mean, std)
        return b

    with _NoDropout():
        step = jax_make_train_step(model, jax_build_loss(cfg.loss.to_dict()),
                                   preprocess=normalize, donate=False)
        new, losses = step(shard_train_state(state, ctx.mesh, fsdp=fsdp), batch,
                           jax.random.PRNGKey(1))
        out = {"losses": {k: float(v) for k, v in losses.items()},
               "norm": float(jax.jit(optax.global_norm)(new.params))}
        if second is not None:
            start = new if restart is None else shard_train_state(
                jax.device_get(restart), ctx.mesh, fsdp=fsdp)
            new2, losses2 = step(start, ctx.shard_host_batch(second), jax.random.PRNGKey(1))
            out["second"] = {"losses": {k: float(v) for k, v in losses2.items()},
                             "norm": float(jax.jit(optax.global_norm)(new2.params))}
    after = jax.tree_util.tree_map(np.asarray, {
        "params": new.params, "batch_stats": new.batch_stats, "ema": new.ema_params})
    return after, out, new


def _pp_bert_config():
    from mammo_clip_tpu.models.bert import BertConfig as JaxBertConfig

    return JaxBertConfig(**dryrun.TINY_PP_BERT, dropout_rate=0.0)


def _pp_init():
    """The JAX package's initial weights of the tiny pipeline BERT, in the
    port's names."""
    from mammo_clip_tpu.models.bert import BertEncoder as JaxBertEncoder

    ids = np.ones((2, 16), np.int32)
    variables = JaxBertEncoder(_pp_bert_config()).init(jax.random.PRNGKey(SEED), ids, ids)
    return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, dict(variables)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' results, the one-process steps (on 8 rows and on 4), the
    payload, and the JAX steps on the 4-device data mesh, the (2, 2) mesh and
    the 2-device data mesh; the JAX steps and the one process run here while
    the ranks run."""
    from concurrent.futures import ThreadPoolExecutor

    host = dryrun.host_batches(dryrun.tiny_dp_config(SEED), RANKS * B, SEED)
    host4 = [{k: v[:2 * B] for k, v in b.items()} for b in host]
    jax_parts = _jax_state(host)
    state = jax_parts[-1]
    init = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                               "batch_stats": state.batch_stats})
    cfg = dryrun.tiny_dp_config(SEED)
    steps = {"cfg": cfg.to_dict(), "batches": host, "sample": False,
             "init": {k: v.clone() for k, v in state_dict_from_jax(init).items()}}
    mesh22 = {"data": 2, "model": 2}
    steps4 = {**steps, "batches": host4}
    tp = {**steps4, "mesh": mesh22, "shard": {"fsdp": True}}
    sp_cfg = dryrun.tiny_dp_config(SEED)
    sp_cfg.model.text_encoder.seq_parallel = True
    draw_cfg = dryrun.tiny_dp_config(SEED)
    draw_cfg.augment.update(affine_p=1.0, elastic_p=1.0)
    emb = _embeddings()
    payload = {"steps": steps,
               "loss": {**emb, "scale": np.float32(14.2857), "smoothing": 0.1},
               "fused": {"ranks": 2, "cases": _fused_cases()},
               "draws": {"cfg": draw_cfg.to_dict(), "seed": SEED,
                         "batch": {k: v[:2] for k, v in host[0].items()
                                   if k in ("images", "image_views")}},
               "tp": tp, "dp2": {**steps4, "mesh": mesh22},
               "checkpoint": {"steps": tp, "dir": str(tmp_path_factory.mktemp("tp_ckpt"))},
               "sp": {**tp, "cfg": sp_cfg.to_dict()},
               "pp": dryrun.pp_payload(dryrun.TINY_PP_BERT, "float32", 8, 16, 4, 1, seed=SEED,
                                       init=_pp_init()),
               "timeout_s": 60.0}
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(dryrun.run_ranks, RANKS, f"{WORKERS}:parity", payload,
                              device="cpu", timeout_s=RANKS_TIMEOUT_S)
        jax_after = _jax_steps(*jax_parts, second=host[1])
        ctx2 = JaxMeshContext.create(data=2, devices=jax.devices()[:2])
        _, jax2, after2 = _jax_steps(jax_parts[0], jax_parts[1], ctx2,
                                     ctx2.shard_host_batch(host4[0]), state, second=host4[1])
        # the (2, 2) mesh's second step starts from the data mesh's first: R13
        ctx22 = JaxMeshContext.create(data=2, model=2, devices=jax.devices()[:4])
        jax22 = _jax_steps(jax_parts[0], jax_parts[1], ctx22, ctx22.shard_host_batch(host4[0]),
                           state, fsdp=True, second=host4[1], restart=after2)[1]
        one = dryrun.steps_case(None, steps)
        steps4_one = {**steps4, "two_steps": False}
        one4 = dryrun.steps_case(None, steps4_one)
        noise4 = dryrun.self_noise(steps4_one, one4)
        out = spawned.result()
    return (out, one, payload, (jax_after[0], jax_after[1]["losses"]), one4, jax22, jax_after[1],
            jax2, noise4)


def test_four_ranks_equal_one_process(ranks):
    """One step and one K=2 call on 4 ranks of 2 rows equal the one-process
    step and K=2 call on the global batch of 8 (the one process's K=2 call
    equal to its two single steps), the same bits on every rank."""
    out, one, *_ = ranks
    cmp = dryrun.compare([r["steps"] for r in out], one)
    assert cmp["same_bits_across_ranks"], cmp
    assert cmp["ok"], cmp
    assert abs(cmp["grad_scale"] - 1.0) <= 1e-4, cmp  # neither 4x too large nor too small
    assert out[0]["steps"]["one"]["step"] == 1 and out[0]["steps"]["k2"]["step"] == 2


def test_dp_step_matches_the_jax_data_mesh_step(ranks):
    """Rank 0 after one DP step (fused route, plain version with the hook)
    against the JAX step on a 4-device data mesh (Flax route)."""
    out, _, _, (after, losses), *_ = ranks
    got = out[0]["steps"]["one"]
    for k, v in losses.items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)
    want = {k: v.numpy().reshape(-1) for k, v in state_dict_from_jax(
        {"params": after["params"], "batch_stats": after["batch_stats"]}).items()}
    ema = {k: v.numpy().reshape(-1) for k, v in state_dict_from_jax(
        {"params": after["ema"], "batch_stats": after["batch_stats"]}).items()}
    assert set(got["params"]) | set(got["buffers"]) == set(want)
    for k, g in got["params"].items():
        np.testing.assert_allclose(g, want[k], rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["ema"][k], ema[k], rtol=0, atol=1e-5, err_msg=k)
    for k, g in got["buffers"].items():
        np.testing.assert_allclose(g, want[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_gathered_loss_matches_shard_map_clip_loss(ranks):
    """Each rank's loss terms equal ``shard_map_clip_loss``'s on a 4-device
    mesh, and its gradients over 4 (see the module docstring) equal JAX's with
    respect to the rank's rows; the single-pair (ConVIRT) loss likewise against
    JAX's ``contrastive_clip_loss`` over the global batch."""
    out, _, payload, *_ = ranks
    p = payload["loss"]
    jmesh = JaxMeshContext.create(data=RANKS, devices=jax.devices()[:RANKS]).mesh
    keys = ("contrastive", "i2t", "t2i", "i2i", "t2t")
    fn = jax.shard_map(
        lambda a, b, c, d: shard_map_clip_loss(
            a, b, jnp.float32(p["scale"]), text_embeddings2=d, image_view_embeddings=c,
            label_smoothing=p["smoothing"]),
        mesh=jmesh, in_specs=(P("data"),) * 4, out_specs={k: P() for k in keys})
    args = [jnp.asarray(p[k]) for k in ("i1", "t1", "i2", "t2")]
    want = jax.jit(fn)(*args)
    grads = jax.jit(jax.grad(lambda *a: fn(*a)["contrastive"], argnums=(0, 1, 2, 3)))(*args)
    single = lambda a, b: jax_contrastive_clip_loss(a, b, jnp.float32(p["scale"]),
                                                    label_smoothing=p["smoothing"])
    want1 = jax.jit(single)(*args[:2])
    grads1 = jax.jit(jax.grad(lambda *a: single(*a)["contrastive"], argnums=(0, 1)))(*args[:2])
    for r, res in enumerate(out):
        rows = slice(r * B, (r + 1) * B)
        for name, w, g, ks in (("multi", want, grads, keys),
                               ("single", want1, grads1, ("contrastive", "i2t", "t2i"))):
            got = res["loss"][name]
            for k in ks:
                np.testing.assert_allclose(got["losses"][k], float(w[k]), rtol=1e-6, err_msg=k)
            for e, ge in zip(("i1", "t1", "i2", "t2"), g):
                np.testing.assert_allclose(got["grads"][e] / RANKS, np.asarray(ge)[rows],
                                           rtol=1e-5, atol=1e-6, err_msg=f"{name} {e}")


@pytest.mark.parametrize("form", ["e6", "e1"])
def test_fused_plain_version_on_two_ranks_equals_the_whole_batch(ranks, form):
    """The fused block's plain version on 2 ranks of 2 images with the
    cross-rank hook equals the call on all 4: out and dx row by row, the
    statistics on each rank, the ranks' parameter gradients summed."""
    out, _, payload, *_ = ranks
    case = payload["fused"]["cases"][form]
    cls = MBConv6Params if form == "e6" else MBConvParams
    x = torch.tensor(case["x"], requires_grad=True)
    p = cls(*[torch.tensor(case["params"][f], requires_grad=True) for f in cls._fields])
    y, stats = plain_fused_mbconv_e6(x, p, torch.tensor(case["delta"]), case["vh"], case["vw"])
    (y * torch.tensor(case["w"])).sum().backward()
    got = [out[r]["fused"][form] for r in range(2)]
    assert out[2]["fused"] == {} and out[3]["fused"] == {}
    close = lambda a, b, name: np.testing.assert_allclose(a, b.detach().numpy(), rtol=1e-5,
                                                          atol=1e-5, err_msg=name)
    close(np.concatenate([g["out"] for g in got]), y, "out")
    close(np.concatenate([g["dx"] for g in got]), x.grad, "dx")
    for g in got:
        for i, s in enumerate(stats):
            close(g["stats"][i], s, f"stat{i}")
    for f, t in zip(cls._fields, p):
        close(got[0]["grads"][f] + got[1]["grads"][f], t.grad, f)


@pytest.mark.parametrize("form", ["e6", "e1"])
def test_fused_plain_version_without_a_hook_keeps_its_bits(form):
    """With no process group the plain version is the one-process function, bit
    for bit: the batch statistics and BatchNorm as they were written before the
    hook existed (``batch_stats``, ``_bn``)."""
    import torch.nn.functional as F

    from mammo_clip_tpu_torch.ops.mbconv import _se_gate, depthwise3x3

    case = _fused_cases()[form]
    cls = MBConv6Params if form == "e6" else MBConvParams
    p = cls(*[torch.tensor(case["params"][f]) for f in cls._fields])
    x, delta = torch.tensor(case["x"]), torch.tensor(case["delta"])
    vh, vw, eps = case["vh"], case["vw"], 1e-3
    xf = x[:, :, :vh, :vw].float()
    stats = []
    if form == "e6":
        z = torch.einsum("nchw,ce->nehw", xf, p.we)
        m0, v0 = batch_stats(z)
        stats += [m0, v0]
        d = depthwise3x3(F.silu(_bn(z, m0, v0, p.gamma0, p.beta0, eps)), p.dw_kernel)
    else:
        d = depthwise3x3(xf, p.dw_kernel)
    m1, v1 = batch_stats(d)
    v = F.silu(_bn(d, m1, v1, p.gamma1, p.beta1, eps))
    u = v * _se_gate(v.mean(dim=(2, 3)), p)[0][:, :, None, None]
    yy = torch.einsum("nehw,ec->nchw", u, p.wp)
    m2, v2 = batch_stats(yy)
    want = delta[:, None, None, None] * _bn(yy, m2, v2, p.gamma2, p.beta2, eps) + xf
    want = F.pad(want, (0, x.shape[3] - vw, 0, x.shape[2] - vh))
    out, got_stats = plain_fused_mbconv_e6(x, p, delta, vh, vw, eps)
    assert torch.equal(out, want)
    for a, b in zip(got_stats, stats + [m1, v1, m2, v2]):
        assert torch.equal(a, b)


def test_ranks_draw_differently_and_rank_zero_as_one_process(ranks):
    """Rank r folds r into its step seed: no two ranks draw the same affine and
    elastic augmentation or drop-connect, and rank 0 draws what one process
    draws."""
    from mammo_clip_tpu_torch.core.config import Config
    from mammo_clip_tpu_torch.ops.stochastic import drop_delta
    from mammo_clip_tpu_torch.train.trainer import make_clip_preprocess

    out, _, payload, *_ = ranks
    d = [r["draws"] for r in out]
    for a in range(RANKS):
        for b in range(a + 1, RANKS):
            for k in ("images", "views", "delta"):
                assert not np.array_equal(d[a][k], d[b][k]), (a, b, k)
    p = payload["draws"]
    gen = torch.Generator().manual_seed(step_seed(p["seed"], 0))
    batch = make_clip_preprocess(Config(p["cfg"]))(
        {k: torch.tensor(v) for k, v in p["batch"].items()}, gen)
    assert np.array_equal(d[0]["images"], batch["images"].numpy())
    assert np.array_equal(d[0]["delta"], drop_delta(16, 0.5, gen, "cpu").numpy())
    assert step_seed(7, 3) == step_seed(7, 3, 0) == (7 * 1_000_003 + 3)


class _Rows:
    def __len__(self):
        return 70

    def __getitem__(self, i):
        return {"image": np.full((4, 3), i % 256, np.uint8), "text": f"row {i}", "label": i}


@pytest.mark.parametrize("weighted", [False, True])
def test_batcher_shards_are_disjoint_complete_and_jax_s(weighted):
    """Rank r's Batcher walks ``order[r::P]`` of the epoch's order, as JAX's
    ``Batcher(process_index=r, process_count=P)``; without weights the ranks'
    slices are disjoint and cover the epoch, every rank yields ``len()``
    batches of its own batch size, and each batch equals JAX's."""
    weights = np.linspace(1.0, 2.0, 70) if weighted else None
    ours = [Batcher(_Rows(), HashTokenizer(vocab_size=128), batch_size=3, max_length=8, seed=4,
                    sample_weights=weights, process_index=r, process_count=RANKS)
            for r in range(RANKS)]
    theirs = [JaxBatcher(_Rows(), JaxHashTokenizer(vocab_size=128), batch_size=3, max_length=8,
                         seed=4, sample_weights=weights, process_index=r, process_count=RANKS)
              for r in range(RANKS)]
    for b in ours + theirs:
        b.set_epoch(2)
    idx = [b._indices() for b in ours]
    for a, t in zip(idx, [b._indices() for b in theirs]):
        np.testing.assert_array_equal(a, t)
    if not weighted:
        assert sorted(np.concatenate(idx).tolist()) == list(range(70))
    assert all(len(b) == 70 // RANKS // 3 == 5 for b in ours)
    for o, t in zip(ours, theirs):
        got, want = list(o), list(t)[:len(o)]  # JAX may yield one more (R12, below)
        assert len(got) == len(o) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])


def test_r12_jax_ranks_yield_unequal_batch_counts_the_port_s_do_not():
    """Fault R12 of the reference: ``mammo_clip_tpu/data/pipeline.py::Batcher``
    yields ``len(order[p::P]) // batch_size`` batches (``__iter__``), which
    differs between processes when P does not divide the epoch: 70 rows, 4
    processes, batch 3 give 6, 6, 5 and 5, while ``__len__`` says 5, so processes
    0-1 would enter a sixth step whose collectives the others never join. Every
    rank of the port yields ``len()`` batches."""
    tok = HashTokenizer(vocab_size=128)
    jax_counts = [len(list(JaxBatcher(_Rows(), JaxHashTokenizer(vocab_size=128), batch_size=3,
                                      max_length=8, process_index=r, process_count=RANKS)))
                  for r in range(RANKS)]
    port_counts = [len(list(Batcher(_Rows(), tok, batch_size=3, max_length=8, process_index=r,
                                    process_count=RANKS))) for r in range(RANKS)]
    assert jax_counts == [6, 6, 5, 5]
    assert port_counts == [5, 5, 5, 5]


def test_r11_the_jax_cli_batch_is_p_times_global_the_port_s_is_not():
    """Fault R11 of the reference: ``mammo_clip_tpu/cli/pretrain.py:44-46`` gives
    each process's Batcher ``ctx.global_batch_size(b)`` rows, which counts every
    process's devices (``core/mesh.py:134-140``), while its own multi-process
    test treats ``Batcher.batch_size`` as per process: with 2 processes one step
    draws 2x the global batch. The port's CLI gives each rank ``b`` rows: P x b."""
    b = 2
    ctx = JaxMeshContext.create()  # the 8 conftest devices: global batch 8b
    rows = [next(iter(JaxBatcher(_Rows(), JaxHashTokenizer(vocab_size=128),
                                 batch_size=ctx.global_batch_size(b), max_length=8,
                                 process_index=p, process_count=2)))["images"].shape[0]
            for p in range(2)]
    assert sum(rows) == 2 * ctx.global_batch_size(b) == 32
    port = [next(iter(Batcher(_Rows(), HashTokenizer(vocab_size=128), batch_size=b,
                              max_length=8, process_index=p, process_count=2)))["images"].shape[0]
            for p in range(2)]
    pctx = mesh.MeshContext(shape=mesh.make_mesh(ranks=2), rank=0,
                            device=torch.device("cpu"))
    assert sum(port) == pctx.global_batch_size(b) == 2 * b


def test_mesh_axes_and_refusals():
    """``make_mesh`` absorbs what ``model`` and ``replica`` leave into ``data``,
    as JAX's does, and refuses a mesh that does not cover the ranks; the
    ranks are laid out as JAX's devices, ``model`` fastest, and the global
    batch counts the batch-carrying ranks only (JAX's ``global_batch_size``);
    with no process group the context is one rank, no collective."""
    assert mesh.make_mesh(ranks=4) == {"replica": 1, "data": 4, "model": 1}
    assert mesh.make_mesh(replica=2, ranks=4) == {"replica": 2, "data": 2, "model": 1}
    assert mesh.make_mesh(model=2, ranks=4) == {"replica": 1, "data": 2, "model": 2}
    assert mesh.make_mesh(model=2, replica=2, ranks=8) == {"replica": 2, "data": 2, "model": 2}
    with pytest.raises(ValueError):
        mesh.make_mesh(data=3, ranks=4)
    with pytest.raises(ValueError):
        mesh.make_mesh(model=3, ranks=4)
    jctx = JaxMeshContext.create(data=2, model=2, devices=jax.devices()[:4])
    for r in range(4):
        c = mesh.MeshContext(shape=mesh.make_mesh(model=2, ranks=4), rank=r,
                             device=torch.device("cpu"))
        where = np.argwhere(jctx.mesh.devices == jax.devices()[r])[0]
        assert (c.data_index, c.model_index) == tuple(where)
        assert c.global_batch_size(3) == jctx.global_batch_size(3) == 6
    ctx = mesh.MeshContext.create(device="cpu", env={})
    assert (ctx.rank, ctx.process_count, ctx.global_batch_size(3)) == (0, 1, 3)
    assert mesh.data_sum() is None and mesh.model_sum() is None and mesh.is_master()
    assert (mesh.world_size(), mesh.data_size(), mesh.data_index(), mesh.model_size(),
            mesh.model_index(), mesh.world_sum()) == (1, 1, 0, 1, 0, None)
    batch = ctx.shard_host_batch({"ids": np.arange(6, dtype=np.int32).reshape(3, 2)})
    assert batch["ids"].dtype == torch.int64 and batch["ids"].shape == (3, 2)


@pytest.mark.parametrize("hooked", [True, False])
@pytest.mark.parametrize("form", ["e6", "e1"])
def test_kernel_path_sums_the_batch_sums_between_passes(monkeypatch, form, hooked):
    """The fused wrapper's kernel path, driven here on CPU tensors against a fake
    library (as ``tests/test_torch_mbconv1.py`` does): the passes run in their
    split order (moments, then bn0; bwd_x, then bn0_bwd), and with a cross-rank
    hook the hook sums exactly the batch sums a later pass reads (x's moments,
    bn1's and bn2's sums; bn2's backward sums, bn1's, bn0's) while every pass
    gets the hook's ranks and bwd_x bn1's summed sums (``sb1``). Without one,
    nothing is summed, the ranks are 1 and ``sb1`` is null: the one-process
    passes on the one-process inputs.""" 
    from mammo_clip_tpu_torch.ops import cuda_lib, mbconv6

    passes = []

    class Lib:
        def __getattr__(self, fn):
            return lambda *args: (passes.append(args), 0)[1]

    monkeypatch.setattr(cuda_lib, "load", Lib)
    monkeypatch.setattr(cuda_lib, "_raw_stream", None)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda d: 0, raising=False)
    monkeypatch.setattr(mbconv6, "_m6_pass", cuda_lib.launcher("m6_pass"))
    monkeypatch.setattr(mbconv6, "_scratch_floats", lambda ints: 4096)
    case = _fused_cases()[form]
    cls = MBConv6Params if form == "e6" else MBConvParams
    p = [torch.tensor(case["params"][f], requires_grad=True) for f in cls._fields]
    x = torch.tensor(case["x"], requires_grad=True)
    summed = []

    class Hook:
        ranks = 3

        def __call__(self, t):
            summed.append(t.numel())
            return t

    out, *_ = mbconv6._FusedMBConv.apply(x, torch.tensor(case["delta"]), case["vh"], case["vw"],
                                          1e-3, cls, Hook() if hooked else None, *p)
    n_fwd = len(passes)
    out.backward(torch.ones_like(out))
    ids = [a[0] for a in passes]
    ep, c2p, cp, e = 48 if form == "e6" else 16, 8, 16, 48 if form == "e6" else 8
    if form == "e6":
        assert ids == [mbconv6.MOMENTS, mbconv6.BN0, mbconv6.F2, mbconv6.F3, mbconv6.F4,
                       mbconv6.OUT, mbconv6.B1, mbconv6.BWD_V, mbconv6.BWD_X, mbconv6.BN0_BWD,
                       mbconv6.DX]
        want = [cp + cp * cp, 2 * ep, 2 * c2p, 2 * c2p, 2 * e, 2 * ep]
    else:
        assert ids == [mbconv6.F2, mbconv6.F3, mbconv6.F4, mbconv6.OUT, mbconv6.B1,
                       mbconv6.BWD_V, mbconv6.BWD_X]
        want = [2 * ep, 2 * c2p, 2 * c2p, 2 * e]
    assert summed == (want if hooked else [])
    sb1 = 1 + mbconv6._PTRS.index("sb1")
    for args in passes:
        assert args[46] == (3 if hooked else 1)  # pass, 34 pointers, eps, 10 ints, ranks
        if args[0] == mbconv6.BWD_X:  # the passes after it keep the pointer and never read it
            assert (args[sb1] is not None) == hooked
        elif args[0] not in (mbconv6.BN0_BWD, mbconv6.DX):
            assert args[sb1] is None
    assert n_fwd == (6 if form == "e6" else 4)


def test_dryrun_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """The dry run's entry point defaults to the card: with none it raises before
    it starts a rank. The device picks what it runs: the tiny CLIP on the CPU,
    the compat recipe at full width in fp32 and in its bf16 on the card (the
    bf16 gradients not held, ``TOLERANCES``), each in the data-parallel
    layout and, with an even number of ranks, the TP + FSDP one; ``compare``
    skips a check whose tolerance is None."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_ranks(*a, **k):
        raise AssertionError("ranks started without a card")

    monkeypatch.setattr(dryrun, "run_ranks", no_ranks)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main([])
    assert list(dryrun.dp_configs("cpu")) == ["tiny"]
    card = dryrun.dp_configs("cuda")
    assert {k: (c.train.dtype, c.data.image_size_h, c.data.batch_size_per_device)
            for k, c in card.items()} == {"full_width": ("float32", 1520, 2),
                                          "full_width_bf16": ("bfloat16", 1520, 2)}
    assert all(dryrun.TOLERANCES[k]["grad"] is None for k in ["full_width_bf16"])
    # the layouts: N data ranks; with an even N also data N/2 x model 2, TP + FSDP
    cases = {n: dryrun.layout_cases(n, "cpu") for n in (1, 2, 4)}
    assert list(cases[1]) == ["tiny"] and list(cases[4]) == ["tiny", "tiny_tp"]
    assert cases[4]["tiny_tp"]["mesh"] == {"data": 2, "model": 2}
    assert cases[2]["tiny_tp"]["mesh"] == {"data": 1, "model": 2}
    assert cases[4]["tiny_tp"]["shard"] == {"fsdp": True}
    assert [len(cases[4][k]["batches"][0]["images"]) for k in ("tiny", "tiny_tp")] == [8, 4]
    run = {"losses": {"total": 1.0}, "grads": {"w": np.ones(3, np.float32)},
           "params": {"w": np.zeros(3, np.float32)}, "buffers": {}, "ema": {}, "digest": "d"}
    bad_grads = {**run, "grads": {"w": np.full(3, 2.0, np.float32)}}
    ranks = [{"one": bad_grads, "k2": run}]
    assert not dryrun.compare(ranks, {"one": run, "k2": run}, "full_width")["ok"]
    assert dryrun.compare(ranks, {"one": run, "k2": run}, "full_width_bf16")["ok"]


def _param_norm(run):
    return float(np.sqrt(sum(float(np.dot(v.astype(np.float64), v)) for v in run["params"].values())))


@pytest.mark.parametrize("case", ["tp", "dp2"])
def test_data2_model2_ranks_equal_one_process(ranks, case):
    """(data 2, model 2) on the first 4 rows: the TP + FSDP placement, and
    whole parameters on 2 data ranks (fault 3.5's layout), each equal to the
    port's one-process step and K=2 call on those rows (``dryrun.compare`` at
    the tiny tolerances, or ``noise`` times one process's own noise in a
    term on these 4 rows where that is larger), the same bits on every
    rank."""
    out, _, _, _, one4, *_, noise4 = ranks
    cmp = dryrun.compare([r[case] for r in out], one4, noise=noise4)
    assert cmp["same_bits_across_ranks"], cmp
    assert cmp["ok"], cmp
    times = dryrun.TOLERANCES["tiny"]["noise"]
    assert cmp["limits"]["step"]["loss"] == max(1e-5, times * noise4["reversed"]["loss"])
    assert cmp["limits"]["k2"]["loss"] == max(1e-5, times * noise4["reversed"]["k2"]["loss"])
    assert out[0][case]["one"]["step"] == 1 and out[0][case]["k2"]["step"] == 2


@pytest.mark.parametrize("case", ["tp", "dp2"])
def test_data2_model2_steps_match_the_jax_2x2_tp_fsdp_step(ranks, case):
    """Rank 0's step on (data 2, model 2) against JAX's TP + FSDP step on a
    (2, 2) mesh: loss and post-update |params| within 1e-4 relative
    (``__graft_entry__.py::dryrun_multichip``'s check), and its K=2 call
    against that mesh's second step, taken from the 2-device data mesh's
    first step (JAX's own first step on the (2, 2) mesh takes a wrong
    gradient: R13, below); the step's and the K=2 call's loss against JAX's
    two steps on the 2-device data mesh within 1e-5, their |params| 1e-4."""
    out, _, _, _, _, jax22, _, jax2, _ = ranks
    got = out[0][case]
    for run, want in ((got["one"], jax22), (got["k2"], jax22["second"])):
        np.testing.assert_allclose(run["losses"]["total"], want["losses"]["total"], rtol=1e-4)
        np.testing.assert_allclose(_param_norm(run), want["norm"], rtol=1e-4)
    for run, want in ((got["one"], jax2), (got["k2"], jax2["second"])):
        np.testing.assert_allclose(run["losses"]["total"], want["losses"]["total"], rtol=1e-5)
        np.testing.assert_allclose(_param_norm(run), want["norm"], rtol=1e-4)


def test_tp_fsdp_leaves_are_shards_and_model_ranks_draw_alike(ranks):
    """Under (data 2, model 2) the ranks of a model group draw the same
    augmentation and drop-connect and the two data groups differ; the
    checkpoint's rank held only its shards: half of a split kernel's expanded
    dim, half of the ZeRO-3 head conv's largest dim."""
    out, *_ = ranks
    d = [r["draws_2x2"] for r in out]
    for k in ("images", "views", "delta"):
        assert np.array_equal(d[0][k], d[1][k]) and np.array_equal(d[2][k], d[3][k]), k
        assert not np.array_equal(d[0][k], d[2][k]), k
    held = out[0]["checkpoint"]["held"]
    assert held["image_encoder.block_2.expand_conv.kernel"] == (72, 24, 1, 1)
    assert held["image_encoder.head_conv.kernel"] == (640, 320, 1, 1)
    assert held["text_encoder.layer_0.intermediate.kernel"] == (32, 32)
    assert held["image_encoder.block_1.expand_conv.kernel"] == (96, 16, 1, 1)  # narrow: whole


def test_tp_fsdp_checkpoint_has_one_process_files_and_restores(ranks):
    """Rank 0 wrote the one-process files (every name and shape of the port's
    model, loadable by ``eval/loading.py``), and restoring them into a fresh
    TP + FSDP placement gives back, on every rank, the parameters, statistics,
    EMA and AdamW moments that were saved."""
    from mammo_clip_tpu_torch.core.config import Config
    from mammo_clip_tpu_torch.eval.loading import load_clip_for_eval
    from mammo_clip_tpu_torch.models import build_model
    from mammo_clip_tpu_torch.train.checkpoint import latest_step

    out, _, payload, *_ = ranks
    ck = payload["checkpoint"]
    for r in out:
        assert r["checkpoint"]["restored"] == r["checkpoint"]["saved"] == out[0]["checkpoint"]["saved"]
        assert r["checkpoint"]["step"] == 1
    assert latest_step(ck["dir"]) == 1
    sd = torch.load(Path(ck["dir"]) / "1" / "state.pt", weights_only=True)
    whole = build_model(Config(ck["steps"]["cfg"]).model.to_dict(), device="cpu").state_dict()
    assert {k: tuple(v.shape) for k, v in sd["model"].items()} == {
        k: tuple(v.shape) for k, v in whole.items()}
    for k in ("ema",):
        assert {n: tuple(v.shape) for n, v in sd[k].items()} == {
            n: tuple(whole[n].shape) for n in sd[k]}
    model, _ = load_clip_for_eval(ck["dir"], device="cpu", use_ema=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd["ema"].get(k, sd["model"][k])), k


def test_r13_jax_2x2_mesh_doubles_a_replicated_depthwise_kernel_gradient(ranks):
    """Fault R13 of the reference's compiler: on a (data 2, model 2) mesh of
    the conftest's CPU devices, with the batch split over ``data`` and the
    kernel replicated, XLA's partitioned gradient of a depthwise convolution's
    kernel is ``model`` times the one device's (so JAX's TP + FSDP step moves
    b0 blocks 0 and 1's depthwise kernels, which no split covers, by a
    doubled gradient, and its second step's loss is 3.5e-3 off); on a data
    mesh it is right, and JAX's data meshes' second step (2 devices on 4
    rows, 4 on 8) gives the port's one-process K=2 loss within 1e-5. The
    port's ranks at (data 2, model 2) take those kernels' gradients as one
    process does."""
    from jax.sharding import Mesh, NamedSharding

    rng = np.random.default_rng(2)
    x, w = (rng.standard_normal((4, 8, 8, 16)).astype(np.float32) for _ in range(2))
    k = rng.standard_normal((3, 3, 1, 16)).astype(np.float32)

    def loss(k, x):
        y = jax.lax.conv_general_dilated(x, k, (1, 1), "SAME", feature_group_count=16,
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return jnp.sum(y * w)

    grad = jax.jit(jax.grad(loss))
    one = np.asarray(grad(k, x))
    scale = {}
    for shape in ((2, 1), (2, 2)):
        m = Mesh(np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(shape), ("data", "model"))
        g = np.asarray(grad(jax.device_put(k, NamedSharding(m, P())),
                            jax.device_put(x, NamedSharding(m, P("data")))))
        scale[shape] = float((g * one).sum() / (one * one).sum())
    assert abs(scale[(2, 1)] - 1) < 1e-5 and abs(scale[(2, 2)] - 2) < 1e-5, scale
    out, one, _, _, one4, _, jax8, jax2, _ = ranks
    for port, want in ((one, jax8), (one4, jax2)):
        np.testing.assert_allclose(port["k2"]["losses"]["total"],
                                   want["second"]["losses"]["total"], rtol=1e-5)
    rel = dryrun.grad_rel(out[0]["tp"]["one"]["grads"], one4["one"]["grads"])
    for b in (0, 1):
        assert rel[f"image_encoder.block_{b}.depthwise_conv.kernel"] <= 1e-4, rel


@pytest.fixture(scope="module")
def jax_sp(ranks):
    """JAX's ``seq_parallel`` TP + FSDP step on a (2, 2) mesh of the
    conftest's devices under ``jax.set_mesh``, as ``tests/test_parallel.py``
    builds it, on the first 4 rows (replicated over the mesh: R13): its
    losses and the state after it."""
    import copy

    from jax.sharding import NamedSharding

    _, _, payload, *_ = ranks
    cfg, _, _, _, state = _jax_state(payload["steps"]["batches"])
    host = payload["tp"]["batches"]
    ctx22 = JaxMeshContext.create(data=2, model=2, devices=jax.devices()[:4])
    model_cfg = copy.deepcopy(cfg.model.to_dict())
    model_cfg["text_encoder"]["seq_parallel"] = True
    with _NoDropout():
        model = jax_build_model(model_cfg)
    batch = {k: jax.device_put(v, NamedSharding(ctx22.mesh, P())) for k, v in host[0].items()}
    with jax.set_mesh(ctx22.mesh):
        after, out, _ = _jax_steps(cfg, model, ctx22, batch, state, fsdp=True)
    return after, out


def test_sp_ranks_equal_one_process_and_the_tp_step(ranks):
    """(data 2, model 2) with ``seq_parallel`` on the first 4 rows: the text
    tower ran on sequence shards (its row splits reduce-scattered over S),
    and the step and K=2 call equal the port's one process on those rows
    (``dryrun.compare``, as the TP case), the same bits on every rank, the
    step's loss the TP step's within the loss tolerance."""
    out, _, _, _, one4, *_, noise4 = ranks
    assert all(r["sp"]["seq_scatters"] > 0 for r in out)
    cmp = dryrun.compare([r["sp"] for r in out], one4, noise=noise4)
    assert cmp["same_bits_across_ranks"], cmp
    assert cmp["ok"], cmp
    tp_loss = out[0]["tp"]["one"]["losses"]["total"]
    assert abs(out[0]["sp"]["one"]["losses"]["total"] - tp_loss) <= 1e-5 * max(1.0, abs(tp_loss))


def test_sp_step_matches_the_jax_seq_parallel_step(ranks, jax_sp):
    """Rank 0's sequence-parallel step against JAX's ``seq_parallel`` step
    on a (2, 2) mesh: the losses within 2e-5 relative, every parameter and
    running statistic within 5e-4 relative and 1e-5 absolute
    (``tests/test_parallel.py:394``, :399)."""
    out, *_ = ranks
    after, losses = jax_sp
    got = out[0]["sp"]["one"]
    for k, v in losses["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=2e-5, err_msg=k)
    want = {k: v.numpy().reshape(-1) for k, v in state_dict_from_jax(
        {"params": after["params"], "batch_stats": after["batch_stats"]}).items()}
    assert set(got["params"]) | set(got["buffers"]) == set(want)
    for k, g in {**got["params"], **got["buffers"]}.items():
        np.testing.assert_allclose(g, want[k], rtol=5e-4, atol=1e-5, err_msg=k)


def test_pp_ranks_over_gloo_equal_the_sequential_tower_and_jax(ranks):
    """The tiny pipeline BERT over 4 gloo ranks, one stage each (the shifts
    point-to-point): the hidden states and every gradient equal the port's
    sequential tower's (``dryrun.compare_pp``; every stage the same outputs
    and embedding gradients), and the hidden states JAX's
    ``pipelined_bert_hidden`` on a 4-device pipe mesh within 2e-5."""
    from jax.sharding import Mesh

    from mammo_clip_tpu.parallel.pipeline import pipelined_bert_hidden as jax_pipelined
    from mammo_clip_tpu_torch.convert.from_jax import variables_from_state_dict

    out, _, payload, *_ = ranks
    p = payload["pp"]
    cmp = dryrun.compare_pp([r["pp"] for r in out], dryrun.pp_one(p))
    assert cmp["ok"] and cmp["pipe"] == 4 and cmp["data"] == 1, cmp
    params = variables_from_state_dict(p["init"])["params"]
    pipe = Mesh(np.asarray(jax.devices()[:4]), ("pipe",))
    want = jax.jit(lambda v: jax_pipelined(v, _pp_bert_config(), p["input_ids"],
                                           p["attention_mask"], pipe, num_stages=4,
                                           num_microbatches=4))(params)
    np.testing.assert_allclose(out[0]["pp"]["hidden"], np.asarray(want), rtol=2e-5, atol=2e-5)
