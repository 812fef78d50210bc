"""BERT text encoder (port of ``mammo_clip_tpu/models/bert.py``).

BioClinicalBERT-compatible architecture returning ``last_hidden_state``; pooling
(eos/bos/mean) happens in the CLIP module. Parameter names and shapes follow
the Flax tree (``layer_3.attention.query.kernel`` is (H, heads, head_dim)), so
``convert/from_jax.py`` maps one onto the other unchanged.

Mixed precision follows Flax's ``dtype``: parameters stay fp32 and are cast to
the activation dtype at use; LayerNorm statistics and the attention softmax run
in fp32. Dropout masks come from an explicit ``torch.Generator``. Attention is
plain ``torch.matmul`` + softmax (``attention``; the JAX package runs it through
XLA, not a Pallas kernel). ``fused_qkv`` computes Q/K/V as one (H, 3H) product
of the three kernels concatenated at run time (same parameter tree);
``amp_attn_scores`` stores the scores in the activation dtype with the softmax
in fp32. ``seq_parallel`` (sequence-sharded activations over a tensor-parallel
mesh) belongs to the distribution slice (ROADMAP queue 9) and raises.

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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.tensor import copy_to_model, reduce_from_model


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
            generator: Optional[torch.Generator], heads=None) -> torch.Tensor:
    """Inverted dropout with a mask drawn from ``generator``. ``heads`` =
    (index, ranks): x holds one model rank's heads (dim 1) of ``ranks``; the
    mask of every head is drawn and this rank's slice kept, so the ranks
    draw what one process draws."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = x.shape if heads is None else (x.shape[0], x.shape[1] * heads[1], *x.shape[2:])
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if heads is not None:
        mask = mask.narrow(1, heads[0] * x.shape[1], x.shape[1])
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


class LayerNorm(nn.Module):
    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias, self.eps)
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
    itself in fp32 (JAX ``models/bert.py:133-151``)."""
    logits = q @ k.transpose(-1, -2)
    keep = mask[:, None, None, :]
    if amp_scores and q.dtype != torch.float32:
        logits = logits.masked_fill(~keep, torch.finfo(q.dtype).min)
        probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    else:
        logits = logits.float().masked_fill(~keep, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
    probs = dropout(probs, dropout_rate, train, generator, heads)
    return probs @ v


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

    def forward(self, x, mask, train: bool, generator=None):
        cfg, tp = self.cfg, self.tp
        d = cfg.hidden_size // cfg.num_heads
        q, k, v = self._qkv(copy_to_model(x, tp))
        ctx = attention((q * d ** -0.5).transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        mask, cfg.amp_attn_scores, cfg.dropout_rate, train, generator,
                        None if tp is None else (tp.index, tp.ranks))
        # ctx (B, N, S, D)
        y = reduce_from_model(self.output(ctx.transpose(1, 2), bias=False), tp)
        return y + self.output.bias.to(y.dtype)


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

    def forward(self, x, mask, train: bool, generator=None):
        rate = self.cfg.dropout_rate
        attn = dropout(self.attention(x, mask, train, generator), rate, train, generator)
        x = self.attention_ln(x + attn)
        h = F.gelu(self.intermediate(copy_to_model(x, self.tp)), approximate="none")
        h = reduce_from_model(self.ffn_output(h, bias=False), self.tp)
        h = dropout(h + self.ffn_output.bias.to(h.dtype), rate, train, generator)
        return self.ffn_ln(x + h)


class BertEncoder(nn.Module):
    """Returns last_hidden_state (B, S, H)."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.seq_parallel:
            raise NotImplementedError("text encoder option seq_parallel is not ported yet "
                                      "(ROADMAP queue 9, distribution)")
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

    def forward(self, input_ids, attention_mask, token_type_ids=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        cfg, dt = self.cfg, self.dtype
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids, dt) + self.position_embeddings(pos, dt)
             + self.token_type_embeddings(token_type_ids, dt))
        x = dropout(self.embeddings_ln(x), cfg.dropout_rate, train, generator)
        mask = attention_mask.bool()
        for i in range(cfg.num_layers):
            layer = getattr(self, f"layer_{i}")
            if cfg.remat and train:
                x = torch.utils.checkpoint.checkpoint(layer, x, mask, train, generator,
                                                      use_reentrant=False)
            else:
                x = layer(x, mask, train, generator)
        return x


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
