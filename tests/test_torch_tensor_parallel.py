"""Tensor parallelism and ZeRO-3 of the port (``parallel/partitioning.py``,
``parallel/tensor.py``) with no process group.

* The rules: the JAX package's tiny CLIP tree (``jax.eval_shape`` of its
  init), carried through ``convert/from_jax.py``, gets from the port's
  ``partition_params`` the axis JAX's ``partition_params`` gives each leaf on a
  (data 2, model 2) mesh of 4 of the conftest's 8 devices, on the dim
  translated to the port's layout (HWIO -> OIHW for conv kernels), with and
  without FSDP: the e=1 and narrow-block gate and ``fsdp_spec``'s choices
  included.
* The Megatron algebra in one process: a tiny BERT layer (1 head and 32 FFN
  columns a shard; dropout off and on) and an eligible b0 block (E = 144, 72 channels a shard), on
  its unfused route and on the fused route's plain version with gathered
  weights, split in two; the two shards run as two threads whose collectives
  a ``ThreadGroup`` sums (``ThreadGroup.run``). Out, dx, the shards' gradients put
  back together and the running statistics equal the whole layer's in fp32.
"""

import copy
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mammo_clip_tpu.core.config import tiny_test_config as jax_tiny_config
from mammo_clip_tpu.core.mesh import make_mesh as jax_make_mesh
from mammo_clip_tpu.models import build_model as jax_build_model
from mammo_clip_tpu.parallel.partitioning import partition_params as jax_partition_params
from mammo_clip_tpu_torch.convert.from_jax import state_dict_from_jax
from mammo_clip_tpu_torch.models.bert import BertConfig, BertLayer
from mammo_clip_tpu_torch.models.efficientnet import MBConvBlock, scaled_block_args
from mammo_clip_tpu_torch.parallel import partitioning as part
from mammo_clip_tpu_torch.parallel.tensor import ThreadGroup

HWIO_TO_OIHW = {0: 2, 1: 3, 2: 1, 3: 0}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """1 intra-op thread: the suite runs its files in parallel processes, and
    torch's default of one thread per core in each oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_tree():
    """The JAX tiny CLIP's parameter shapes (no compute) and its params as zeros."""
    cfg = jax_tiny_config()
    model = jax_build_model(cfg.model.to_dict())
    h, w, s = cfg.data.image_size_h, cfg.data.image_size_w, cfg.data.text_max_length
    batch = {"images": jnp.zeros((2, h, w, 1)), "image_views": jnp.zeros((2, h, w, 1)),
             "input_ids": jnp.ones((2, s), jnp.int32), "attention_mask": jnp.ones((2, s), jnp.int32),
             "input_ids2": jnp.ones((2, s), jnp.int32), "attention_mask2": jnp.ones((2, s), jnp.int32)}
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "dropout", "stochastic"))}
    shapes = jax.eval_shape(lambda: model.init(rngs, batch, train=False))["params"]
    return shapes


@pytest.mark.parametrize("fsdp", [False, True])
def test_port_specs_are_jax_specs_in_the_port_layout(jax_tree, fsdp):
    jmesh = jax_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    jspecs = jax.tree_util.tree_flatten_with_path(
        jax_partition_params(jax_tree, jmesh, fsdp=fsdp))[0]
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), jax_tree)
    ported = state_dict_from_jax({"params": zeros})
    specs = part.partition_params({k: tuple(v.shape) for k, v in ported.items()},
                                  {"data": 2, "model": 2}, fsdp)
    seen = {"model": 0, "data": 0}
    for kp, sharding in jspecs:
        name = ".".join(str(getattr(k, "key", k)) for k in kp)
        jspec = tuple(sharding.spec)
        conv = part._is_conv_kernel(name, ported[name].shape)
        want = {}
        for d, axis in enumerate(jspec):
            if axis is not None:
                want[HWIO_TO_OIHW[d] if conv else d] = axis
        got = {d: a for d, a in enumerate(specs[name]) if a is not None}
        assert got == want, (name, jspec, specs[name])
        for a in got.values():
            seen[a] += 1
    assert seen["model"] > 0 and (seen["data"] > 0) == fsdp, seen
    # the gate: e=1 blocks (no expand_conv) and narrow ones (E / 2 < 64) stay whole
    assert specs["image_encoder.block_0.depthwise_conv.kernel"] == ()
    assert specs["image_encoder.block_1.expand_conv.kernel"] == ()  # E = 96
    assert specs["image_encoder.block_2.expand_conv.kernel"][0] == "model"  # E = 144
    assert specs["text_encoder.word_embeddings.embedding"] == (None, None)


def test_rules_name_the_flagship_front_and_fsdp_ties():
    """The flagship's ``tpu_front_block_*`` names are matched as JAX's are
    (``tests/test_parallel.py``), stems and heads stay replicated, and a tie
    between an OIHW kernel's O and I dims takes I, the first in JAX's HWIO."""
    assert part.spec_for_path("image_encoder.tpu_front_block_0.project_conv.kernel") == (
        None, "model", None, None)
    assert part.spec_for_path("image_encoder.tpu_front_block_1.expand_conv.kernel")[0] == "model"
    for name in ("image_encoder.stem_conv.kernel", "image_encoder.head_conv.kernel", "logit_scale"):
        assert part.spec_for_path(name) == ()
    assert part.fsdp_spec((512, 512, 1, 1), 2, (), conv=True) == (None, "data", None, None)
    assert part.fsdp_spec((512, 512), 2, ()) == ("data", None)
    assert part.fsdp_spec((255, 257), 2, ()) == ()  # no divisible dim
    assert part.fsdp_spec((100, 100), 2, ()) == ()  # under FSDP_MIN_SIZE


def _put_back(whole, shards, name):
    """The shards' tensors of ``name`` concatenated on their split dim (or the
    first, when ``name`` is not split), against the whole layer's."""
    parts = [s[name] for s in shards]
    if parts[0].shape == whole.shape:
        for p in parts[1:]:
            assert torch.equal(p, parts[0]), name  # replicated: the same bits on each
        return parts[0]
    dim = next(d for d in range(whole.dim()) if parts[0].shape[d] != whole.shape[d])
    return torch.cat(parts, dim)


def _held(layer, prefix, run, tol):
    """``run(module, r)`` -> (out, dx, module) on the whole layer and on two
    shards; out and dx per shard, the gradients and buffers put back."""
    whole = copy.deepcopy(layer)
    y, dx, _ = run(whole, None)
    group = ThreadGroup(2)

    def shard_run(r):
        m = copy.deepcopy(layer)
        part.place(m, {"model": group.rank(r), "data": None}, prefix=prefix)
        out, d, m = run(m, r)
        return out, d, {k: p.grad for k, p in m.named_parameters()}, dict(m.named_buffers())

    res = group.run(shard_run, timeout_s=120.0)
    for out, d, _, _ in res:
        np.testing.assert_allclose(out.detach().numpy(), y.detach().numpy(), rtol=tol, atol=tol)
        np.testing.assert_allclose(d.numpy(), dx.numpy(), rtol=tol, atol=tol)
    for k, p in whole.named_parameters():
        got = _put_back(p.grad, [r[2] for r in res], k)
        np.testing.assert_allclose(got.numpy(), p.grad.numpy(), rtol=tol, atol=tol, err_msg=k)
    for k, b in whole.named_buffers():
        got = _put_back(b, [r[3] for r in res], k)
        np.testing.assert_allclose(got.numpy(), b.numpy(), rtol=tol, atol=tol, err_msg=k)
    return res


@pytest.mark.parametrize("fused_qkv,rate", [(False, 0.0), (True, 0.0), (False, 0.1)])
def test_bert_layer_split_by_heads_and_ffn_columns_equals_the_whole(fused_qkv, rate):
    """With dropout on, every rank draws from the same seed what the whole
    layer draws: the attention's mask for every head, its own heads' kept."""
    cfg = dataclasses.replace(BertConfig.tiny(), dropout_rate=rate, fused_qkv=fused_qkv)
    gen = torch.Generator().manual_seed(3)
    layer = BertLayer(cfg)
    for p in layer.parameters():
        p.data = 0.2 * torch.randn(p.shape, generator=gen)
    x = torch.randn(2, 7, cfg.hidden_size, generator=gen)
    mask = torch.ones(2, 7, dtype=torch.bool)
    mask[1, 4:] = False
    g = torch.randn(2, 7, cfg.hidden_size, generator=gen)

    def run(m, r):
        xr = x.clone().requires_grad_()
        y = m(xr, mask, True, torch.Generator().manual_seed(7))
        y.backward(g)
        return y, xr.grad, m

    res = _held(layer, "text_encoder.layer_0", run, 1e-5)
    assert res[0][2]["attention.query.kernel"].shape == (32, 1, 16)  # 1 of 2 heads
    assert res[1][2]["intermediate.kernel"].shape == (32, 32)


@pytest.mark.parametrize("fused", [False, True])
def test_mbconv_block_split_over_its_expanded_dim_equals_the_whole(fused):
    """b0 block 2 (24 -> 24, E = 144, k3, stride 1: the fused route's block),
    drop-connect on: unfused, the column->row split with the SE squeeze and
    the projection summed over the shards; fused (the plain version on the
    CPU), the block's shards gathered and the whole block run on each."""
    args = scaled_block_args("b0")[2]
    assert args.expanded == 144
    gen = torch.Generator().manual_seed(4)
    block = MBConvBlock(args, 0.1)
    for p in block.parameters():
        p.data = 0.3 * torch.randn(p.shape, generator=gen)
    x = torch.randn(4, 24, 8, 8, generator=gen)
    delta = torch.tensor([1.25, 0.0, 1.25, 1.25])
    g = torch.randn(4, 24, 8, 8, generator=gen)

    def run(m, r):
        xr = x.clone().requires_grad_()
        y = m(xr, True, delta, fused=fused)
        y.backward(g)
        return y, xr.grad, m

    res = _held(block, "image_encoder.block_2", run, 1e-4)
    assert res[0][2]["expand_conv.kernel"].shape == (72, 24, 1, 1)
    assert res[0][2]["project_conv.kernel"].shape == (24, 72, 1, 1)
    assert res[0][3]["bn1.mean"].shape == (72,) and res[0][3]["bn2.mean"].shape == (24,)


def test_thread_group_run_raises_when_a_rank_fails():
    """A rank that raises aborts the group's barrier: the rank waiting at it
    fails too, and ``ThreadGroup.run`` raises at once instead of waiting."""
    group = ThreadGroup(2, timeout_s=60.0)

    def fn(r):
        if r == 1:
            raise ValueError("rank 1 fails")
        return group.rank(r)(torch.ones(3))

    start = time.perf_counter()
    with pytest.raises(RuntimeError, match="failed"):
        group.run(fn, timeout_s=60.0)
    assert time.perf_counter() - start < 30
    assert group.run(lambda r: r, timeout_s=10.0) == [0, 1]
