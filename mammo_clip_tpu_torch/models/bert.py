"""BERT text encoder (port of ``mammo_clip_tpu/models/bert.py``).

BioClinicalBERT-compatible architecture returning ``last_hidden_state``; pooling
(eos/bos/mean) happens in the CLIP module. Parameter names and shapes follow
the Flax tree (``layer_3.attention.query.kernel`` is (H, heads, head_dim)), so
``convert/from_jax.py`` maps one onto the other unchanged.

Mixed precision follows Flax's ``dtype``: parameters stay fp32 and are cast to
the activation dtype at use; LayerNorm statistics and the attention softmax run
in fp32 (in float64 for a float64 run). Dropout masks come from an explicit
``torch.Generator``. Attention is plain ``torch.matmul`` + softmax
(``attention``; the JAX package runs it through XLA, not a Pallas kernel). ``fused_qkv`` computes Q/K/V as one (H, 3H) product
of the three kernels concatenated at run time (same parameter tree);
``amp_attn_scores`` stores the scores in the activation dtype with the softmax
in fp32.

Tensor parallelism (``parallel/partitioning.py``, Megatron-style over the
mesh's ``model`` axis): a layer whose ``tp`` is set holds N / model heads of
query, key and value (column-split, by heads) and the matching rows of the
attention output, and I / model columns of ``intermediate`` with the matching
rows of ``ffn_output``. Its replicated input enters through
``copy_to_model``, the row-split products are summed by
``reduce_from_model``, and a row-split layer's bias is added once, after the
sum; a layer that is not split runs the same code, whose collectives are then
the identity (Dense adds its bias after the product either way). Embeddings
and LayerNorms stay replicated. The ranks of a model group
draw the same dropout (their step seeds are the data index's): the
attention's mask is drawn for every head and each rank keeps its heads', so
a split layer drops what the whole layer drops.

Sequence parallelism (``seq_parallel``, Megatron's, over the same ``model``
axis; JAX ``models/bert.py:170-181``, :214-215): when every layer is split
and the ranks divide S, the encoder keeps this rank's S-slice of the
embeddings after their dropout (``parallel/constraint.py::shard_seq``), so
the LayerNorms, residuals and the two residual dropouts run on a (B, S /
model, H) shard. The column-split products read the whole sequence through
``gather_from_seq`` (backward: a reduce-scatter) in place of
``copy_to_model``; the row-split products leave through
``reduce_scatter_to_seq`` in place of ``reduce_from_model``'s all-reduce,
the bias added once, on the shard. A parameter used on the shard (the
LayerNorms', the two row-split biases) enters through ``copy_to_model``, so
each rank's gradient for it sums every rank's tokens, as a replicated
parameter's must. A residual dropout draws the whole (B, S, H) mask and
keeps this rank's slice. The encoder ends by gathering S
(``gather_from_model``: backward, the rank's own slice), so the pooling and
the projection see (B, S, H). Without a split, or when S does not divide,
``seq_parallel`` changes nothing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.constraint import seq_axis, shard_seq
from ..parallel.tensor import (copy_to_model, gather_from_model, gather_from_seq,
                               reduce_from_model, reduce_scatter_to_seq)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 28996  # Bio_ClinicalBERT (BERT-base-cased vocab)
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dropout_rate: float = 0.1
    remat: bool = False
    fused_qkv: bool = False
    amp_attn_scores: bool = False
    seq_parallel: bool = False

    @classmethod
    def tiny(cls) -> "BertConfig":
        return cls(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                   intermediate_size=64, max_position_embeddings=64)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator], part=None) -> torch.Tensor:
    """Inverted dropout with a mask drawn from ``generator``. ``part`` =
    (index, ranks): x holds one model rank's part of dim 1 of ``ranks`` (its
    heads, or its S-slice); the mask of the whole is drawn and this rank's
    slice kept, so the ranks draw what one process draws."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = x.shape if part is None else (x.shape[0], x.shape[1] * part[1], *x.shape[2:])
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if part is not None:
        mask = mask.narrow(1, part[0] * x.shape[1], x.shape[1])
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Dense(nn.Module):
    """x @ kernel (+ bias) over the trailing ``len(in_shape)`` dims; the kernel is
    (*in_shape, *out_shape) as in Flax Dense/DenseGeneral. The shapes are read
    from the kernel at each call, so a tensor-parallel shard runs as it is;
    ``bias=False`` leaves the bias to the caller (added after a row split's sum)."""

    def __init__(self, in_shape, out_shape, use_bias: bool = True):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.kernel = nn.Parameter(torch.empty(*self.in_shape, *self.out_shape))
        self.bias = nn.Parameter(torch.zeros(*self.out_shape)) if use_bias else None

    def forward(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        dt, n_in = x.dtype, len(self.in_shape)
        kernel = self.kernel
        lead = x.shape[: x.dim() - n_in]
        k = kernel.to(dt).reshape(math.prod(kernel.shape[:n_in]), -1)
        y = x.reshape(-1, k.shape[0]) @ k
        if bias and self.bias is not None:
            y = y + self.bias.to(dt).reshape(-1)
        return y.reshape(*lead, *kernel.shape[n_in:])


def _at_least_fp32(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


class LayerNorm(nn.Module):
    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, seq=None) -> torch.Tensor:
        """``seq``: x is this rank's S-slice over that axis (sequence
        parallelism); the scale and bias then enter through ``copy_to_model``."""
        y = F.layer_norm(x.to(_at_least_fp32(x.dtype)), (x.shape[-1],),
                         copy_to_model(self.scale, seq), copy_to_model(self.bias, seq), self.eps)
        return y.to(x.dtype)


class Embed(nn.Module):
    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, features))

    def forward(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.embedding(ids, self.embedding.to(dtype))


def attention(q, k, v, mask, amp_scores: bool, dropout_rate: float = 0.0, train: bool = False,
              generator: Optional[torch.Generator] = None, heads=None) -> torch.Tensor:
    """Softmax attention of (B, N, S, D) ``q`` (already scaled), ``k``, ``v`` over
    the keys where the (B, S) bool ``mask`` holds; returns (B, N, S, D) in v's
    dtype. The scores are fp32, or with ``amp_scores`` and a non-fp32 dtype kept
    in that dtype (masked keys at its most negative value) with the softmax
    itself in fp32 (JAX ``models/bert.py:133-151``); float64 stays float64."""
    logits = q @ k.transpose(-1, -2)
    keep = mask[:, None, None, :]
    wide = _at_least_fp32(q.dtype)
    if amp_scores and q.dtype != wide:
        logits = logits.masked_fill(~keep, torch.finfo(q.dtype).min)
        probs = torch.softmax(logits.to(wide), dim=-1).to(v.dtype)
    else:
        logits = logits.to(wide).masked_fill(~keep, torch.finfo(wide).min)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
    probs = dropout(probs, dropout_rate, train, generator, heads)
    return probs @ v


def _enter(x, tp, seq):
    """A column split's input: the whole sequence gathered from the S-slices
    under sequence parallelism, else the replicated tensor."""
    return gather_from_seq(x, seq) if seq is not None else copy_to_model(x, tp)


def _leave(y, tp, seq):
    """A row split's partial products summed: this rank's S-slice of the sum
    under sequence parallelism, else the whole sum."""
    return reduce_scatter_to_seq(y, seq) if seq is not None else reduce_from_model(y, tp)


def _part(seq):
    return None if seq is None else (seq.index, seq.ranks)


class BertSelfAttention(nn.Module):
    tp = None  # the model axis of a head split (parallel/partitioning.py)

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        h, n = cfg.hidden_size, cfg.num_heads
        d = h // n
        self.query = Dense((h,), (n, d))
        self.key = Dense((h,), (n, d))
        self.value = Dense((h,), (n, d))
        self.output = Dense((n, d), (h,))

    def _qkv(self, x):
        """(B, S, N, D) query, key and value: three products, or with
        ``fused_qkv`` one (H, 3H) product of the kernels concatenated at run
        time (JAX ``models/bert.py:118-131``)."""
        if not self.cfg.fused_qkv:
            return self.query(x), self.key(x), self.value(x)
        kernels = [m.kernel for m in (self.query, self.key, self.value)]
        w = torch.cat([k.reshape(x.shape[-1], -1) for k in kernels], dim=1).to(x.dtype)
        b = torch.cat([m.bias.reshape(-1) for m in (self.query, self.key, self.value)])
        qkv = x @ w + b.to(x.dtype)
        return [t.reshape(*x.shape[:-1], *kernels[0].shape[1:]) for t in qkv.chunk(3, dim=-1)]

    def forward(self, x, mask, train: bool, generator=None, seq=None):
        """``seq``: x is this rank's S-slice over that axis (the model axis,
        sequence parallelism), and so is the output."""
        cfg, tp = self.cfg, self.tp
        d = cfg.hidden_size // cfg.num_heads
        q, k, v = self._qkv(_enter(x, tp, seq))
        ctx = attention((q * d ** -0.5).transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        mask, cfg.amp_attn_scores, cfg.dropout_rate, train, generator,
                        None if tp is None else (tp.index, tp.ranks))
        # ctx (B, N, S, D)
        y = _leave(self.output(ctx.transpose(1, 2), bias=False), tp, seq)
        return y + copy_to_model(self.output.bias, seq).to(y.dtype)


class BertLayer(nn.Module):
    tp = None  # the model axis of the FFN's split (parallel/partitioning.py)

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = BertSelfAttention(cfg)
        self.attention_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.intermediate = Dense((cfg.hidden_size,), (cfg.intermediate_size,))
        self.ffn_output = Dense((cfg.intermediate_size,), (cfg.hidden_size,))
        self.ffn_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x, mask, train: bool, generator=None, seq=None):
        """``seq``: x is this rank's S-slice over that axis (the model axis,
        sequence parallelism), and so is the output."""
        rate, part = self.cfg.dropout_rate, _part(seq)
        attn = dropout(self.attention(x, mask, train, generator, seq), rate, train, generator,
                       part)
        x = self.attention_ln(x + attn, seq)
        h = F.gelu(self.intermediate(_enter(x, self.tp, seq)), approximate="none")
        h = _leave(self.ffn_output(h, bias=False), self.tp, seq)
        h = dropout(h + copy_to_model(self.ffn_output.bias, seq).to(h.dtype), rate, train,
                    generator, part)
        return self.ffn_ln(x + h, seq)


class BertEncoder(nn.Module):
    """Returns last_hidden_state (B, S, H)."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.word_embeddings = Embed(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = Embed(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = Embed(cfg.type_vocab_size, cfg.hidden_size)
        self.embeddings_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", BertLayer(cfg))

    @property
    def out_dim(self) -> int:
        return self.cfg.hidden_size

    def embed(self, input_ids, token_type_ids=None, dtype: Optional[torch.dtype] = None):
        """The embeddings' sum after their LayerNorm (before the dropout)."""
        dt = self.dtype if dtype is None else dtype
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids, dt) + self.position_embeddings(pos, dt)
             + self.token_type_embeddings(token_type_ids, dt))
        return self.embeddings_ln(x)

    def model_axis(self):
        """The model axis every layer and its attention are split over, or
        None when one is not split (``parallel/partitioning.py::place``)."""
        axes = [m.tp for i in range(self.cfg.num_layers)
                for m in (getattr(self, f"layer_{i}"), getattr(self, f"layer_{i}").attention)]
        return axes[0] if axes and all(a is not None for a in axes) else None

    def forward(self, input_ids, attention_mask, token_type_ids=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        x = dropout(self.embed(input_ids, token_type_ids), cfg.dropout_rate, train, generator)
        seq = seq_axis(x, self.model_axis()) if cfg.seq_parallel else None
        x = shard_seq(x, seq)
        mask = attention_mask.bool()
        for i in range(cfg.num_layers):
            layer = getattr(self, f"layer_{i}")
            if cfg.remat and train:
                x = torch.utils.checkpoint.checkpoint(layer, x, mask, train, generator, seq,
                                                      use_reentrant=False)
            else:
                x = layer(x, mask, train, generator, seq)
        return x if seq is None else gather_from_model(x, 1, seq)


def pool_text(hidden: torch.Tensor, attention_mask: torch.Tensor, pooling: str) -> torch.Tensor:
    """eos: feature at index sum(mask)-1; bos: index 0; mean: mask-weighted mean."""
    if pooling == "eos":
        idx = attention_mask.sum(dim=-1).long() - 1
        return hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
    if pooling == "bos":
        return hidden[:, 0]
    if pooling == "mean":
        m = attention_mask[..., None].to(hidden.dtype)
        return (hidden * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-9)
    raise NotImplementedError(f"unsupported pooling: {pooling}")
