"""The GPipe text tower of the port (``parallel/pipeline.py``) against the
JAX package's (``mammo_clip_tpu/parallel/pipeline.py``) and against the
sequential tower, with no process group: the stages run as threads of one
process whose shifts and sums a ``ThreadGroup`` computes (a data 2 x pipe 4
layout as 8 threads, two pipe groups of 4). The gloo ranks' pipe of 4, one
stage a process, is in ``tests/test_torch_parallel.py``.

* ``stack_layer_params``: stage s's layers of the port's state dict equal
  JAX's stacked leaves ``[s, j]`` on the same tree; an indivisible stage
  count raises as JAX's does.
* The identity schedule (stage i adds i + 1, M = 6, P = 4) delivers each
  microbatch through every stage once, as JAX's ``pipeline_apply`` does.
* The tiny BERT of ``tests/test_pipeline.py::_bert`` (4 layers, hidden 16,
  JAX's initial weights) on 4 thread stages and on data 2 x pipe 4: the
  hidden states within 2e-5 of JAX's ``pipelined_bert_hidden`` on the same
  meshes and of the port's sequential encoder, the fp32 gradients of every
  layer and of the embeddings within 2e-5 of the sequential ones; in
  float64 (B = 4, S = 8, M = 2, as JAX's gradient test) within JAX's 1e-9
  relative and 1e-11 absolute.
* ``pipe_axes`` makes JAX's (data, pipe) layout: pipe index ``rank % P``,
  data index ``rank // P``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from mammo_clip_tpu.models.bert import BertConfig as JaxBertConfig
from mammo_clip_tpu.models.bert import BertEncoder as JaxBertEncoder
from mammo_clip_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply
from mammo_clip_tpu.parallel.pipeline import pipelined_bert_hidden as jax_pipelined
from mammo_clip_tpu.parallel.pipeline import stack_layer_params as jax_stack
from mammo_clip_tpu_torch.convert.from_jax import load_jax_variables, state_dict_from_jax
from mammo_clip_tpu_torch.models.bert import BertConfig, BertEncoder
from mammo_clip_tpu_torch.parallel import pipeline
from mammo_clip_tpu_torch.parallel.dryrun import TINY_PP_BERT
from mammo_clip_tpu_torch.parallel.tensor import ThreadGroup


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """1 intra-op thread: the suite runs its files in parallel processes, and
    torch's default of one thread per core in each oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mesh(shape, names):
    return Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)


def _bert(B=8, S=16, seed=0):
    """JAX's pipeline test's tiny BERT (``tests/test_pipeline.py::_bert``):
    its config, encoder, variables and inputs."""
    cfg = JaxBertConfig(**TINY_PP_BERT, dropout_rate=0.0)
    enc = JaxBertEncoder(cfg)
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.int32)
    mask[:, 0] = 1
    variables = enc.init(jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(mask))
    return cfg, enc, jax.tree_util.tree_map(np.asarray, dict(variables)), ids, mask


def _port(variables, dtype=torch.float32):
    enc = BertEncoder(BertConfig(**TINY_PP_BERT, dropout_rate=0.0), dtype=dtype)
    load_jax_variables(enc, variables)
    return enc.to(dtype) if dtype == torch.float64 else enc


def _run_stages(enc, ids, mask, pipe, data, microbatches, w):
    """The port's pipelined tower on ``data`` x ``pipe`` thread ranks (pipe
    fastest), each its own copy of ``enc``: every rank's hidden states of its
    rows, its rows, and its gradients of sum(h * w) over them."""
    import copy

    pipes = [ThreadGroup(pipe, timeout_s=60.0) for _ in range(data)]
    datas = [ThreadGroup(data, timeout_s=60.0) for _ in range(pipe)]

    def rank(r):
        m = copy.deepcopy(enc)
        p_axis = pipes[r // pipe].rank(r % pipe)
        d_axis = datas[r % pipe].rank(r // pipe) if data > 1 else None
        h = pipeline.pipelined_bert_hidden(m, torch.from_numpy(ids).long(),
                                           torch.from_numpy(mask).long(), p_axis, d_axis,
                                           num_stages=pipe, num_microbatches=microbatches)
        rows = pipeline.pipeline_rows(len(ids), microbatches, data, r // pipe)
        (h * w[rows]).sum().backward()
        return h.detach(), rows, {k: p.grad for k, p in m.named_parameters() if p.grad is not None}

    return ThreadGroup(pipe * data).run(rank)


def _assemble(res, pipe, data, like):
    """The hidden states of every row from each data rank's first stage, and
    each gradient summed over the data ranks (a layer's from its stage)."""
    hidden = torch.zeros_like(like)
    grads = {}
    for r, (h, rows, g) in enumerate(res):
        first = res[r - r % pipe]
        assert torch.equal(h, first[0])  # every stage holds the replicated output
        if r % pipe == 0:
            hidden[rows] = h
        for k, v in g.items():
            if k.startswith("layer_"):
                grads[k] = grads.get(k, 0) + v
            else:
                assert torch.equal(v, first[2][k]), k  # every stage the embeddings' gradient
                if r % pipe == 0:
                    grads[k] = grads.get(k, 0) + v
    return hidden, grads


@pytest.mark.parametrize("stages", [1, 2, 4])
def test_stack_layer_params_is_jax_s_on_the_same_tree(stages):
    _, _, variables, _, _ = _bert()
    want = jax_stack(variables["params"], num_stages=stages)
    sd = state_dict_from_jax(variables)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for s in range(stages):
        got = pipeline.stack_layer_params(sd, stages, s)
        assert len(got) == 4 // stages
        prefixed = pipeline.stack_layer_params({f"text_encoder.{k}": v for k, v in sd.items()},
                                               stages, s, prefix="text_encoder.layer_")
        for j, layer in enumerate(got):
            assert set(layer) == {".".join(str(k.key) for k in kp) for kp, _ in flat}
            for kp, leaf in flat:
                name = ".".join(str(k.key) for k in kp)
                np.testing.assert_array_equal(layer[name].numpy(), np.asarray(leaf)[s, j])
                assert torch.equal(prefixed[j][name], layer[name])
    with pytest.raises(ValueError):
        jax_stack(variables["params"], num_stages=3)
    with pytest.raises(ValueError):
        pipeline.stack_layer_params(sd, 3, 0)
    with pytest.raises(ValueError):
        pipeline.stack_layer_params({"word_embeddings.embedding": torch.zeros(1)}, 1, 0)


def test_identity_schedule_is_jax_s():
    """Stage i adds i + 1: each of M = 6 microbatches passes every stage once
    (+10), on 4 thread stages as on JAX's 4-device pipe mesh; the inputs'
    gradient of the outputs' sum is 1 everywhere on stage 0, which alone
    reads them, and 0 on the others (the sum's backward is the identity)."""
    mbs = np.arange(24.0, dtype=np.float32).reshape(6, 2, 2)
    run = jax.shard_map(lambda sp, xs: jax_pipeline_apply(lambda p, x: x + jnp.sum(p), sp, xs,
                                                          "pipe"),
                        mesh=_mesh((4,), ("pipe",)), in_specs=(P("pipe"), P()), out_specs=P())
    want = np.asarray(run(jnp.arange(1.0, 5.0).reshape(4, 1, 1, 1), mbs))
    np.testing.assert_allclose(want, mbs + 10.0)
    group = ThreadGroup(4)

    def rank(r):
        x = torch.from_numpy(mbs).requires_grad_()
        (out,) = pipeline.pipeline_apply(lambda t: (t[0] + (r + 1),), (x,), group.rank(r))
        out.sum().backward()
        return out.detach(), x.grad

    for r, (out, grad) in enumerate(group.run(rank)):
        np.testing.assert_array_equal(out.numpy(), want)
        assert torch.equal(grad, torch.full((6, 2, 2), 1.0 if r == 0 else 0.0))


@pytest.mark.parametrize("data", [1, 2])
def test_pipelined_bert_matches_jax_and_the_sequential_encoder(data):
    """4 stages (1 layer each), 4 microbatches of 2 rows; with data 2 each
    data rank streams 1 row of every microbatch. The hidden states equal
    JAX's ``pipelined_bert_hidden`` on the (pipe 4) or (data 2, pipe 4) mesh
    and the port's sequential encoder within 2e-5, and the gradients of
    every layer and of the embeddings (word embeddings included) the
    sequential ones within 2e-5."""
    cfg, _, variables, ids, mask = _bert()
    if data == 1:
        jmesh, kw = _mesh((4,), ("pipe",)), {}
    else:
        jmesh, kw = _mesh((2, 4), ("data", "pipe")), {"data_axis": "data"}
    want = np.asarray(jax.jit(lambda v: jax_pipelined(v, cfg, ids, mask, jmesh, num_stages=4,
                                                      num_microbatches=4, **kw))(
        variables["params"]))
    enc = _port(variables)
    w = torch.tensor(np.random.default_rng(6).standard_normal((8, 16, 16)), dtype=torch.float32)
    seq = _port(variables)
    h_seq = seq(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    (h_seq * w).sum().backward()
    hidden, grads = _assemble(_run_stages(enc, ids, mask, 4, data, 4, w), 4, data, h_seq.detach())
    np.testing.assert_allclose(hidden.numpy(), want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(hidden, h_seq.detach(), rtol=2e-5, atol=2e-5)
    named = dict(seq.named_parameters())
    assert set(grads) == set(named)
    for k, g in grads.items():
        torch.testing.assert_close(g, named[k].grad, rtol=2e-5, atol=2e-5, msg=k)


def test_pipelined_bert_gradients_match_the_sequential_ones_in_float64():
    """JAX's gradient test (``tests/test_pipeline.py``: B = 4, S = 8, M = 2,
    float64, loss sum(h * h)): a schedule fault survives any precision,
    while float64 leaves ~1e-12 of reassociation noise, so the layers' and
    the word embeddings' gradients are held at JAX's 1e-9 relative and
    1e-11 absolute (the port's LayerNorm and softmax stay in float64 for a
    float64 run)."""
    _, _, variables, ids, mask = _bert(B=4, S=8)
    seq = _port(variables, torch.float64)
    h = seq(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    (h * h).sum().backward()
    enc = _port(variables, torch.float64)
    group = ThreadGroup(4)

    def rank(r):
        import copy

        m = copy.deepcopy(enc)
        out = pipeline.pipelined_bert_hidden(m, torch.from_numpy(ids).long(),
                                             torch.from_numpy(mask).long(), group.rank(r),
                                             num_microbatches=2)
        (out * out).sum().backward()
        return out.detach(), {k: p.grad for k, p in m.named_parameters() if p.grad is not None}

    res = group.run(rank)
    torch.testing.assert_close(res[0][0], h.detach(), rtol=1e-12, atol=1e-12)
    named = dict(seq.named_parameters())
    for i in range(4):
        for k, p in named.items():
            if k.startswith(f"layer_{i}."):
                torch.testing.assert_close(res[i][1][k], p.grad, rtol=1e-9, atol=1e-11, msg=k)
    for r in range(4):
        torch.testing.assert_close(res[r][1]["word_embeddings.embedding"],
                                   named["word_embeddings.embedding"].grad, rtol=1e-9, atol=1e-11)


def test_pipeline_rows_and_refusals():
    """Data rank d streams rows ``m * mb + d * mb / D ..`` of each microbatch
    m (JAX's ``P(None, "data")`` over the (M, mb) layout); a batch that the
    microbatches, or a microbatch that the data ranks, do not divide
    raises, as does a stage count that is not the pipe's."""
    assert pipeline.pipeline_rows(8, 4).tolist() == list(range(8))
    assert pipeline.pipeline_rows(8, 4, 2, 0).tolist() == [0, 2, 4, 6]
    assert pipeline.pipeline_rows(8, 2, 2, 1).tolist() == [2, 3, 6, 7]
    with pytest.raises(ValueError):
        pipeline.pipeline_rows(8, 3)
    with pytest.raises(ValueError):
        pipeline.pipeline_rows(8, 4, 4, 0)
    _, _, variables, ids, mask = _bert()
    with pytest.raises(ValueError):
        pipeline.pipelined_bert_hidden(_port(variables), torch.from_numpy(ids).long(),
                                       torch.from_numpy(mask).long(), ThreadGroup(1).rank(0),
                                       num_stages=2)


def test_pipe_axes_lay_ranks_out_as_jax_s_data_pipe_mesh(monkeypatch):
    """On a world of 8 (process groups recorded, not made): each rank's pipe
    group is its row of JAX's ``devices.reshape(2, 4)`` mesh over ("data",
    "pipe") and its data group its column, every rank making every group in
    one order."""
    import torch.distributed as dist

    devices = np.arange(8).reshape(2, 4)
    made = {}
    for r in range(8):
        calls = []
        monkeypatch.setattr(dist, "get_world_size", lambda group=None: 8 if group is None
                            else len(group))
        monkeypatch.setattr(dist, "get_rank", lambda group=None, r=r: r if group is None
                            else group.index(r))
        monkeypatch.setattr(dist, "new_group", lambda ranks: calls.append(ranks) or ranks)
        pipe, data = pipeline.pipe_axes(4)
        made[r] = calls
        where = np.argwhere(devices == r)[0]
        assert pipe.group == devices[where[0]].tolist() and pipe.index == where[1]
        assert data.group == devices[:, where[1]].tolist() and data.index == where[0]
        assert (pipe.ranks, data.ranks) == (4, 2)
    assert all(c == made[0] for c in made.values())
