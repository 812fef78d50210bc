"""Parameter partitioning: Megatron splits over ``model`` and ZeRO-3 over
``data`` (port of ``mammo_clip_tpu/parallel/partitioning.py``).

The rules are JAX's, matched against the port's dotted names (the Flax tree's,
``convert/from_jax.py``) and translated to the port's layouts: a spec is a
tuple with one entry a dim, the axis that splits it or None; ``()`` is
replicated. Dense kernels keep Flax's shapes (``models/bert.py``), so their
specs are JAX's. Conv kernels are OIHW here and HWIO in JAX: the expanded dim
E is dim 0 of ``expand_conv``, ``depthwise_conv`` and ``se.expand`` and dim 1
of ``se.reduce`` and ``project_conv``. The first matching rule wins.

A block of the image tower is split only when it has an ``expand_conv`` and
E / model >= 64 (JAX's structural gate, :146-156): e=1 blocks and narrow
blocks stay replicated. The running statistics of a split BatchNorm (its
``mean`` and ``var``) follow its scale: the port computes them on the channel
shard, where JAX keeps ``batch_stats`` replicated and lets GSPMD gather them.

``fsdp_spec`` shards each leaf of at least ``FSDP_MIN_SIZE`` elements that
no rule splits on its largest dim divisible by the data ranks, the first such
dim in JAX's layout on a tie. A leaf a rule names (BERT's word embeddings:
``(None, None)``) keeps its spec, as in JAX.

``shard_train_state`` places a built train state on this process's mesh
(``core/mesh.py``), in place: each split tensor keeps only this rank's slice
(``.data`` narrowed; the optimizer's moments, its accumulator and the EMA
likewise), tagged with its ``Shard``. The modules of a Megatron split get
their model axis (``tp``: ``BertSelfAttention``, ``BertLayer``,
``MBConvBlock``), which runs their collectives (``parallel/tensor.py``). A
module holding a ZeRO-3 shard reads the whole parameter through a property
that gathers it over ``data`` (``gather_shards``: the backward reduce-scatters
the gradient as a mean), at every read: in the forward and again in a
rematerialised block's recompute. ``full_tensors`` and ``load_full`` gather
and narrow state dicts, for snapshots and checkpoints.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch

from ..core import mesh
from .tensor import gather_shards

Spec = Tuple[Optional[str], ...]

_TEXT = r"^text_encoder\.layer_\d+\."
_BLOCK = r"^image_encoder\.[^.]*block_\d+\."
PARTITION_RULES: List[Tuple[str, Spec]] = [
    (_TEXT + r"attention\.(query|key|value)\.kernel$", (None, "model", None)),
    (_TEXT + r"attention\.(query|key|value)\.bias$", ("model", None)),
    (_TEXT + r"attention\.output\.kernel$", ("model", None, None)),
    (_TEXT + r"intermediate\.kernel$", (None, "model")),
    (_TEXT + r"intermediate\.bias$", ("model",)),
    (_TEXT + r"ffn_output\.kernel$", ("model", None)),
    (r"^text_encoder\.word_embeddings\.embedding$", (None, None)),
    # image tower, OIHW: a column->row pair over each MBConv's expanded dim
    (_BLOCK + r"expand_conv\.kernel$", ("model", None, None, None)),
    (_BLOCK + r"bn0\.(scale|bias|mean|var)$", ("model",)),
    (_BLOCK + r"depthwise_conv\.kernel$", ("model", None, None, None)),
    (_BLOCK + r"bn1\.(scale|bias|mean|var)$", ("model",)),
    (_BLOCK + r"se\.reduce\.kernel$", (None, "model", None, None)),
    (_BLOCK + r"se\.expand\.kernel$", ("model", None, None, None)),
    (_BLOCK + r"se\.expand\.bias$", ("model",)),
    (_BLOCK + r"project_conv\.kernel$", (None, "model", None, None)),
]

FSDP_MIN_SIZE = 2 ** 16  # don't shard tiny leaves (BN scales, biases)


def spec_for_path(path: str) -> Spec:
    for pattern, spec in PARTITION_RULES:
        if re.search(pattern, path):
            return spec
    return ()


def _is_conv_kernel(name: str, shape) -> bool:
    """A 4-D ``kernel`` leaf, except Swin's (C, 3, heads, head_dim) ``qkv``
    (``convert/from_jax.py``): OIHW here, HWIO in JAX."""
    return name.endswith(".kernel") and len(shape) == 4 and not name.endswith("qkv.kernel")


def fsdp_spec(shape, data_size: int, base: Spec, conv: bool = False) -> Spec:
    """ZeRO-3 spec of a leaf: its largest dim divisible by ``data_size`` over
    ``data`` (the first in JAX's HWIO order on a tie, for an OIHW ``conv``
    kernel), when it has at least ``FSDP_MIN_SIZE`` elements and no rule
    names it (``base`` is ``()``)."""
    if base != () or not shape:
        return base
    if math.prod(shape) < FSDP_MIN_SIZE:
        return ()
    order = (2, 3, 1, 0) if conv else range(len(shape))
    dims = [d for d in order if shape[d] % data_size == 0 and shape[d] > 1]
    if not dims:
        return ()
    d = max(dims, key=lambda i: shape[i])
    return tuple("data" if i == d else None for i in range(len(shape)))


def partition_params(shapes: Mapping[str, tuple], mesh_shape: Mapping[str, int],
                     fsdp: bool = False) -> Dict[str, Spec]:
    """The spec of every leaf of ``shapes`` (dotted name -> shape, the
    parameters and optionally the BatchNorm buffers) on a mesh of
    ``mesh_shape`` axis sizes: the rules, with a block's split only where
    it passes the gate, then ``fsdp_spec`` with ``fsdp``."""
    data_size, model_size = mesh_shape.get("data", 1), mesh_shape.get("model", 1)
    eligible = set()
    for name, shape in shapes.items():
        m = re.search(r"(.*block_\d+)\.expand_conv\.kernel$", name)
        if m and shape:
            e = shape[0]
            if e % model_size == 0 and e // model_size >= 64:
                eligible.add(m.group(1))
    specs = {}
    for name, shape in shapes.items():
        spec = spec_for_path(name)
        if spec != () and name.startswith("image_encoder"):
            bm = re.search(r"(.*block_\d+)\.", name)
            if bm and bm.group(1) not in eligible:
                spec = ()
        if fsdp and not name.endswith((".mean", ".var")):
            spec = fsdp_spec(tuple(shape), data_size, spec, _is_conv_kernel(name, shape))
        specs[name] = spec
    return specs


class Shard(NamedTuple):
    """A tensor's split: the axis' name, its collectives (``core/mesh.py::
    RankSum`` or a ``ThreadGroup`` rank) and the dim."""
    axis: str
    group: object
    dim: int


def shard_of(t: torch.Tensor) -> Optional[Shard]:
    return getattr(t, "_mc_shard", None)


def _narrow(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    n = t.shape[shard.dim] // shard.group.ranks
    return t.narrow(shard.dim, shard.group.index * n, n).clone()


_GATHERING: Dict[Tuple[type, Tuple[str, ...]], type] = {}


def _gathering_class(cls: type, names: Tuple[str, ...]) -> type:
    """A subclass of ``cls`` whose ``names`` read the whole parameter,
    gathered over ``data`` from the shard registered under that name."""
    key = (cls, names)
    if key not in _GATHERING:
        def prop(name):
            def get(self):
                p = self._parameters[name]
                s = shard_of(p)
                return gather_shards(p, s.dim, s.group)
            return property(get)

        _GATHERING[key] = type(cls.__name__, (cls,), {n: prop(n) for n in names})
    return _GATHERING[key]


def _owner(model: torch.nn.Module, name: str):
    path, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    return (model.get_submodule(path) if path else model), leaf


def default_axes() -> Dict[str, object]:
    """This process's axes (``core/mesh.py``): the model and data groups' sums,
    None where the axis has one rank."""
    return {"model": mesh.model_sum(), "data": mesh.data_sum()}


def place(module: torch.nn.Module, axes: Mapping[str, object], fsdp: bool = False,
          prefix: str = "") -> Dict[str, Tuple[Shard, tuple]]:
    """Split ``module``'s parameters and buffers in place, as
    ``partition_params`` says for their names (``prefix`` + "." + the
    module's own: a layer placed alone is named as in the whole model), on
    the axes of ``axes`` ("model", "data": collectives, or None for one
    rank); give each Megatron split's module its model axis (``tp``) and
    each ZeRO-3 shard's owner its gathering property. Returns {name: (Shard,
    the whole shape)} of the tensors it split."""
    sizes = {k: (a.ranks if a is not None else 1) for k, a in axes.items()}
    tensors = {**dict(module.named_parameters()), **dict(module.named_buffers())}
    full_name = lambda k: f"{prefix}.{k}" if prefix else k
    specs = partition_params({full_name(k): tuple(v.shape) for k, v in tensors.items()}, sizes,
                             fsdp)
    split: Dict[str, Tuple[Shard, tuple]] = {}
    gathered: Dict[torch.nn.Module, List[str]] = {}
    for name, t in tensors.items():
        dims = [(d, a) for d, a in enumerate(specs[full_name(name)])
                if a is not None and sizes[a] > 1]
        if not dims:
            continue
        (dim, axis), = dims
        shard = Shard(axis, axes[axis], dim)
        split[name] = (shard, tuple(t.shape))
        t.data = _narrow(t.data, shard)
        t._mc_shard = shard
        owner, leaf = _owner(module, name)
        if axis == "model":  # the nearest module that runs the split's collectives
            path = name
            while not hasattr(owner, "tp"):
                if "." not in path:
                    raise ValueError(f"{name}: split over model, but no module runs its split")
                path = path.rsplit(".", 1)[0]
                owner, _ = _owner(module, path)
            owner.tp = axes["model"]
        else:
            gathered.setdefault(owner, []).append(leaf)
    for owner, names in gathered.items():
        owner.__class__ = _gathering_class(type(owner), tuple(sorted(names)))
    return split


def shard_train_state(state, fsdp: bool = False, axes: Optional[Mapping[str, object]] = None):
    """Place ``state`` (built whole, the same on every rank) on the mesh in
    place and return it: the Megatron splits over ``model``, ZeRO-3 over
    ``data`` with ``fsdp``, the optimizer's moments, its accumulator and the
    EMA following their parameters. ``axes`` (``default_axes()`` by default)
    maps "model" and "data" to their collectives, None for an axis of one
    rank."""
    axes = default_axes() if axes is None else axes
    params = dict(state.model.named_parameters())
    split = place(state.model, axes, fsdp)
    opt_state, acc = state.optimizer.inner.state, state.optimizer._acc
    index = {id(p): i for i, p in enumerate(state.optimizer.params)}
    for name, (shard, full) in split.items():
        if name not in params:
            continue
        t = params[name]
        for k, v in opt_state.get(t, {}).items():
            if torch.is_tensor(v) and tuple(v.shape) == full:
                opt_state[t][k] = _narrow(v, shard)
        if acc is not None:
            acc[index[id(t)]] = _narrow(acc[index[id(t)]], shard)
        if state.ema is not None:
            state.ema[name] = _narrow(state.ema[name], shard)
            state.ema[name]._mc_shard = shard
    return state


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a shard (gathered over its axis; every rank of the
    axis takes part), or ``t`` itself."""
    s = shard_of(t)
    return t if s is None else s.group.gather(t.detach(), s.dim)


def full_like(like: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` (a gradient or a moment of the parameter ``like``) whole: gathered
    along ``like``'s shard, or ``t`` itself when ``like`` is whole."""
    s = shard_of(like)
    return t if s is None else s.group.gather(t.detach().contiguous(), s.dim)


def full_tensors(tensors: Mapping[str, torch.Tensor],
                 like: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Each tensor whole: gathered along its own ``Shard``, or the one of the
    tensor of the same name in ``like`` (a gradient's parameter)."""
    return {k: full_like(t if like is None else like[k], t) for k, t in tensors.items()}


def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with every shard gathered whole: the names and
    shapes one process has."""
    tensors = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    return {k: full_tensor(tensors[k]).detach() if k in tensors else v  # state_dict's
            for k, v in model.state_dict().items()}  # own tensors carry no Shard


def local_slice(like: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """This rank's slice of ``full`` for the shard ``like`` (``full`` itself
    when ``like`` is whole)."""
    s = shard_of(like)
    return full if s is None else _narrow(full, s)


def load_full(model: torch.nn.Module, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load a whole state dict (one process's names and shapes) into a model
    that may hold shards: each sharded tensor takes its slice."""
    tensors = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    model.load_state_dict({k: local_slice(tensors[k], v) if k in tensors else v
                           for k, v in state_dict.items()})
