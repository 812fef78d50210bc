"""Sequence parallelism of the port (``parallel/constraint.py``, the sequence
collectives of ``parallel/tensor.py``, ``models/bert.py`` with
``seq_parallel``) with no process group: the model ranks run as threads of
one process whose collectives a ``ThreadGroup`` computes
(``ThreadGroup.run``), held to the whole layer and encoder in fp32 and to
the JAX package.

* ``shard_seq``'s no-op cases are JAX's (no axis, one rank, fewer than 2
  dims, an S the ranks do not divide); an eager call shards (JAX's raises
  under an active mesh: R3).
* The collectives' forward and backward against what they compute.
* A tiny BERT layer and encoder (2 heads, 1 a rank; FFN 32 columns a rank)
  split in two with ``seq_parallel``, dropout off and on, with
  ``fused_qkv``, under remat: out and every gradient (the shards put back
  together) equal the whole's within 1e-5; the encoder also JAX's
  ``seq_parallel`` encoder under ``jax.set_mesh`` on a (1, 2) mesh.
* With no model axis, with S not divisible, or with ``seq_parallel`` off,
  the encoder gives the bits it gives without the option (the parent's
  path), and the LayerNorm and attention casts give the bits of
  ``x.float()`` in fp32 and bf16.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mammo_clip_tpu.core.mesh import make_mesh as jax_make_mesh
from mammo_clip_tpu.models.bert import BertConfig as JaxBertConfig
from mammo_clip_tpu.models.bert import BertEncoder as JaxBertEncoder
from mammo_clip_tpu.parallel import shard_seq as jax_shard_seq
from mammo_clip_tpu_torch.convert.from_jax import load_jax_variables
from mammo_clip_tpu_torch.models.bert import (BertConfig, BertEncoder, BertLayer, LayerNorm,
                                              attention)
from mammo_clip_tpu_torch.parallel import MODEL_AXIS, shard_seq
from mammo_clip_tpu_torch.parallel.partitioning import place
from mammo_clip_tpu_torch.parallel.tensor import (ThreadGroup, gather_from_seq,
                                                  reduce_scatter_to_seq, scatter_to_seq,
                                                  shift_to_next)

TINY = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2, intermediate_size=64,
            max_position_embeddings=32)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """1 intra-op thread: the suite runs its files in parallel processes, and
    torch's default of one thread per core in each oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _put_back(whole, parts):
    if parts[0].shape == whole.shape:
        for p in parts[1:]:
            assert torch.equal(p, parts[0])  # a replicated tensor: the same bits on each rank
        return parts[0]
    dim = next(d for d in range(whole.dim()) if parts[0].shape[d] != whole.shape[d])
    return torch.cat(parts, dim)


def _seeded(module, seed=0, scale=0.3):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(scale * torch.randn(p.shape, generator=g))
    return module


def test_shard_seq_is_the_identity_in_jax_s_no_op_cases():
    """No axis, an axis of one rank, a 1-D tensor, S not divisible: the
    tensor itself; the port names the axis as JAX does."""
    assert MODEL_AXIS == "model"
    x = torch.randn(2, 6, 4)
    assert shard_seq(x, None) is x
    assert shard_seq(x, ThreadGroup(1).rank(0)) is x
    two = ThreadGroup(2).rank(0)
    flat, odd = torch.randn(6), torch.randn(2, 5, 4)
    assert shard_seq(flat, two) is flat and shard_seq(odd, two) is odd
    y = jnp.ones((2, 6, 4))
    assert jax_shard_seq(y) is y  # JAX's, with no mesh


def test_r3_jax_shard_seq_raises_eagerly_the_port_s_does_not():
    """Fault R3 of the reference: ``parallel/constraint.py:48`` raises when
    called eagerly under an active mesh. The port's eager call shards: each
    rank keeps its S-slice, and the backward gathers the cotangent."""
    mesh = jax_make_mesh(data=1, model=2, devices=jax.devices()[:2])
    eager = jnp.ones((2, 6, 4))  # on one device, as an eager value is
    with jax.set_mesh(mesh), pytest.raises(TypeError, match="NamedSharding"):
        jax_shard_seq(eager)
    x = torch.randn(2, 6, 4)
    group = ThreadGroup(2)

    def rank(r):
        xr = x.clone().requires_grad_()
        y = shard_seq(xr, group.rank(r))
        (y * (r + 1)).sum().backward()
        return y.detach(), xr.grad

    out = group.run(rank)
    for r, (y, g) in enumerate(out):
        assert torch.equal(y, x[:, 3 * r:3 * r + 3])
        want = torch.cat([torch.full((2, 3, 4), 1.0), torch.full((2, 3, 4), 2.0)], 1)
        assert torch.equal(g, want)  # every rank's cotangent slice, gathered


@pytest.mark.parametrize("name", ["scatter", "gather", "reduce_scatter", "shift"])
def test_sequence_collectives_forward_and_backward(name):
    """On 2 ranks (4 for the shift) of seeded tensors: each collective's
    forward and its backward for a seeded cotangent, against the sums and
    slices they stand for."""
    n = 4 if name == "shift" else 2
    rng = np.random.default_rng(3)
    xs = [torch.tensor(rng.standard_normal((2, 4 if name != "gather" else 2, 3))) for _ in range(n)]
    gs = [torch.tensor(rng.standard_normal((2, 4 if name == "gather" else 2, 3)))
          if name != "shift" else torch.tensor(rng.standard_normal((2, 4, 3)))
          for _ in range(n)]
    fn = {"scatter": scatter_to_seq, "gather": gather_from_seq,
          "reduce_scatter": reduce_scatter_to_seq, "shift": shift_to_next}[name]
    group = ThreadGroup(n)

    def rank(r):
        x = xs[r].clone().requires_grad_()
        y = fn(x, group.rank(r))
        y.backward(gs[r])
        return y.detach(), x.grad

    out = group.run(rank)
    half = lambda t, r: t[:, 2 * r:2 * r + 2]
    for r, (y, dx) in enumerate(out):
        if name == "scatter":
            want_y, want_dx = half(xs[r], r), torch.cat(gs, 1)
        elif name == "gather":
            want_y, want_dx = torch.cat(xs, 1), half(gs[0] + gs[1], r)
        elif name == "reduce_scatter":
            want_y, want_dx = half(xs[0] + xs[1], r), torch.cat(gs, 1)
        else:
            want_y = xs[r - 1] if r else torch.zeros_like(xs[0])
            want_dx = gs[r + 1] if r + 1 < n else torch.zeros_like(gs[0])
        torch.testing.assert_close(y, want_y, rtol=0, atol=1e-15)
        torch.testing.assert_close(dx, want_dx, rtol=0, atol=1e-15)


def _sp_runs(module, run, prefix):
    """``run(module) -> (out, {name: grad})`` on the whole module and on two
    model ranks (threads, ``place``d), the ranks' gradients put back."""
    whole = copy.deepcopy(module)
    w = run(whole)
    group = ThreadGroup(2)

    def rank(r):
        m = copy.deepcopy(module)
        place(m, {"model": group.rank(r), "data": None}, prefix=prefix)
        return run(m)

    res = group.run(rank)
    grads = {k: _put_back(g, [x[1][k] for x in res]) for k, g in w[1].items()}
    return w, res, grads


@pytest.mark.parametrize("rate,fused", [(0.0, False), (0.3, False), (0.3, True)])
def test_sp_layer_equals_the_whole_layer(rate, fused):
    """A tiny BERT layer split in two with its input on sequence shards (the
    column splits read the gathered sequence, the row splits reduce-scatter,
    the LayerNorms and residual dropouts run on the shard): each rank's
    output and input gradient are its S-slice of the whole layer's, and the
    parameter gradients equal the whole's (1e-5), dropout drawn as one
    process draws it."""
    cfg = BertConfig(**TINY, dropout_rate=rate, fused_qkv=fused)
    layer = _seeded(BertLayer(cfg))
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((3, 8, 16)), dtype=torch.float32)
    gy = torch.tensor(rng.standard_normal((3, 8, 16)), dtype=torch.float32)
    mask = torch.arange(8)[None] < torch.tensor([[8], [5], [2]])

    def run(m):
        seq = m.tp
        xr = (x if seq is None else x.narrow(1, 4 * seq.index, 4)).clone().requires_grad_()
        y = m(xr, mask, True, torch.Generator().manual_seed(7), seq)
        y.backward(gy if seq is None else gy.narrow(1, 4 * seq.index, 4))
        return (y.detach(), xr.grad), {k: p.grad for k, p in m.named_parameters()}

    (want, wgrads), res, grads = _sp_runs(layer, run, "text_encoder.layer_0")
    for r, ((y, dx), _) in enumerate(res):
        torch.testing.assert_close(y, want[0][:, 4 * r:4 * r + 4], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(dx, want[1][:, 4 * r:4 * r + 4], rtol=1e-5, atol=1e-5)
    for k, g in wgrads.items():
        torch.testing.assert_close(grads[k], g, rtol=1e-5, atol=1e-5, msg=k)


def _jax_encoder(cfg, seed=2):
    jcfg = JaxBertConfig(**TINY, dropout_rate=0.0, seq_parallel=True,
                         fused_qkv=cfg.fused_qkv)
    ids = np.ones((2, 8), np.int32)
    model = JaxBertEncoder(jcfg)
    return model, model.init(jax.random.PRNGKey(seed), ids, ids)


@pytest.mark.parametrize("rate,fused,remat", [(0.0, False, False), (0.3, True, False),
                                              (0.3, False, True)])
def test_sp_encoder_equals_the_whole_and_jax(rate, fused, remat):
    """The tiny encoder (JAX's initial weights) with ``seq_parallel`` split in
    two: the embeddings sharded after their dropout, every layer on shards,
    the output gathered. Its output and every gradient of sum(h * w) equal
    the whole encoder's (1e-5), also under the non-reentrant remat, where
    the recompute issues the collectives again; with dropout off its output
    equals JAX's ``seq_parallel`` encoder under ``jax.set_mesh`` on a (1, 2)
    mesh (1e-5)."""
    cfg = BertConfig(**TINY, dropout_rate=rate, fused_qkv=fused, remat=remat, seq_parallel=True)
    jmodel, variables = _jax_encoder(cfg)
    enc = BertEncoder(cfg)
    load_jax_variables(enc, jax.tree_util.tree_map(np.asarray, dict(variables)))
    rng = np.random.default_rng(4)
    ids = rng.integers(1, 64, size=(3, 8)).astype(np.int32)
    mask = (np.arange(8)[None] < np.array([[8], [6], [3]])).astype(np.int32)
    w = torch.tensor(rng.standard_normal((3, 8, 16)), dtype=torch.float32)

    def run(m):
        h = m(torch.from_numpy(ids).long(), torch.from_numpy(mask), train=True,
              generator=torch.Generator().manual_seed(9))
        (h * w).sum().backward()
        return h.detach(), {k: p.grad for k, p in m.named_parameters()}

    (want, wgrads), res, grads = _sp_runs(enc, run, "text_encoder")
    assert enc.model_axis() is None  # the whole one is not split
    for h, _ in res:
        torch.testing.assert_close(h, want, rtol=1e-5, atol=1e-5)
    for k, g in wgrads.items():
        torch.testing.assert_close(grads[k], g, rtol=1e-5, atol=1e-5, msg=k)
    if rate == 0.0:
        mesh = jax_make_mesh(data=1, model=2, devices=jax.devices()[:2])
        with jax.set_mesh(mesh):
            jh = jax.jit(lambda v: jmodel.apply(v, ids, mask, deterministic=True))(variables)
        np.testing.assert_allclose(res[0][0].numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sp_off_no_axis_or_indivisible_s_keeps_the_bits(dtype):
    """``seq_parallel`` on with no model axis gives the bits of the encoder
    without it, forward and backward, fp32 and bf16; split in two with S = 7
    (not divisible) it gives the TP split's bits; the LayerNorm and the
    attention take the bits of their fp32 cast (``x.float()``) in fp32 and
    bf16."""
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(1, 64, size=(2, 7))).long()
    mask = torch.ones(2, 7, dtype=torch.long)
    w = torch.tensor(rng.standard_normal((2, 7, 16)), dtype=torch.float32)
    runs = {}
    for sp in (False, True):
        enc = _seeded(BertEncoder(BertConfig(**TINY, dropout_rate=0.2, seq_parallel=sp),
                                  dtype=dtype))

        def run(m):
            h = m(ids, mask, train=True, generator=torch.Generator().manual_seed(3))
            (h.float() * w).sum().backward()
            return h.detach(), {k: p.grad for k, p in m.named_parameters()}

        runs[sp] = _sp_runs(enc, run, "text_encoder")
    (whole, res, grads), (whole_sp, res_sp, grads_sp) = runs[False], runs[True]
    assert torch.equal(whole[0], whole_sp[0])  # no model axis
    for k in whole[1]:
        assert torch.equal(whole[1][k], whole_sp[1][k]), k
        assert torch.equal(grads[k], grads_sp[k]), k  # split in two, S = 7
    for a, b in zip(res, res_sp):
        assert torch.equal(a[0], b[0])
    x = torch.randn(4, 16, dtype=dtype)
    ln = _seeded(LayerNorm(16, 1e-12))
    want = F.layer_norm(x.float(), (16,), ln.scale, ln.bias, 1e-12).to(dtype)
    assert torch.equal(ln(x), want)
    q, k, v = (torch.randn(2, 2, 5, 8, dtype=dtype) for _ in range(3))
    m = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]]).bool()
    logits = (q @ k.transpose(-1, -2)).float().masked_fill(~m[:, None, None, :],
                                                          torch.finfo(torch.float32).min)
    want = torch.softmax(logits, dim=-1).to(dtype) @ v
    assert torch.equal(attention(q, k, v, m, amp_scores=False), want)
    if dtype == torch.bfloat16:
        logits = (q @ k.transpose(-1, -2)).masked_fill(~m[:, None, None, :],
                                                      torch.finfo(dtype).min)
        want = torch.softmax(logits.float(), dim=-1).to(dtype) @ v
        assert torch.equal(attention(q, k, v, m, amp_scores=True), want)


def test_bert_config_seq_parallel_defaults_off():
    """The option is off by default, and a model config's key reaches it."""
    from mammo_clip_tpu_torch.models.clip import bert_config_from_model_config

    assert BertConfig().seq_parallel is False
    mc = {"text_encoder": {"seq_parallel": True}}
    assert bert_config_from_model_config(mc).seq_parallel is True
    assert dataclasses.replace(BertConfig.tiny(), seq_parallel=True).seq_parallel
