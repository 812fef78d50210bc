"""Warm-start the flagship (``tpu_optimized``) encoder from reference-exact
weights (port of ``mammo_clip_tpu/convert/flagship_init.py``, numpy only).

The flagship is not checkpoint-compatible with the reference: a
space-to-depth front replaces the stem and the blocks above 1/4 scale, and
the deep stages' widths are remapped to multiples of 128
(``models/efficientnet.py``). Its deep blocks keep the reference topology and
names, so a reference-exact checkpoint (a port ``best/`` or a public ``.tar``)
seeds most of its parameters:

* text tower, projection heads, ``logit_scale``: copied as they are;
* deep image blocks (``block_{i}`` from the front's skip on): each tensor is
  remapped channel by channel. Where a width SHRANK (176->128 I/O, 1056->1024
  expanded) the channels kept are picked by a data-free magnitude saliency
  (producer kernel-column norm x BN scale x consumer kernel-row norm), one
  selection per tied channel space (a residual chain shares its I/O space
  across the stage and with the next stage's entry; an e=1 block's expanded
  space is its input space). Where a width GREW (64->128 at the entry) the
  source channels fill the leading slots and the rest keep their fresh init;
* the front (``tpu_stem_*``, ``tpu_front_block_*``) has no reference
  counterpart and keeps its fresh init.

Trees are ``{"params", "batch_stats"}`` of numpy arrays with Flax's layout
(conv kernels HWIO), so the selection is the JAX module's numpy arithmetic on
the same arrays; ``warm_start_state_dict`` reaches the port's state dicts
through ``convert/from_jax.py``. A warm START, not a function-preserving
conversion: dropped and fresh channels change the output, and training goes on
from there.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from .from_jax import state_dict_from_jax, variables_from_state_dict


def _embed_slab(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Copy src into dst over the overlapping hyperslab; keep dst elsewhere."""
    src = np.asarray(src)
    dst = np.array(dst, copy=True)
    if src.shape == dst.shape:
        return src.astype(dst.dtype, copy=False)
    if src.ndim != dst.ndim:
        return dst  # structurally different leaf (shouldn't happen) — keep init
    sl = tuple(slice(0, min(s, d)) for s, d in zip(src.shape, dst.shape))
    dst[sl] = src[sl]
    return dst


def _overlay(src: Dict[str, Any], dst: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, dv in dst.items():
        if k in src and isinstance(dv, dict):
            out[k] = _overlay(src[k], dv)
        elif k in src:
            out[k] = _embed_slab(src[k], dv)
        else:
            out[k] = dv  # no source (s2d front, wider-only leaves): fresh init
    return out


# ---------------------------------------------------------------------------
# Importance-ranked channel selection for shrunk widths
# ---------------------------------------------------------------------------


class _UnionFind:
    def __init__(self):
        self._p: Dict[Any, Any] = {}

    def find(self, k):
        self._p.setdefault(k, k)
        while self._p[k] != k:
            self._p[k] = self._p[self._p[k]]
            k = self._p[k]
        return k

    def union(self, a, b):
        self._p[self.find(a)] = self.find(b)


def _norm(x: np.ndarray, keep_axis: int) -> np.ndarray:
    """L2 over every axis but keep_axis (fp32), as a 1-D per-channel magnitude."""
    x = np.asarray(x, np.float32)
    axes = tuple(i for i in range(x.ndim) if i != keep_axis)
    return np.sqrt(np.sum(x * x, axis=axes))


def _block_leaves(params: Dict, stats: Dict, name: str) -> Dict[str, np.ndarray]:
    """Flatten one block's param+stat leaves to path->array (paths relative)."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            p = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, p)
            else:
                out[p] = np.asarray(v)

    walk(params.get(name, {}), "")
    if name in stats:
        walk(stats[name], "stats")
    return out


def _select_indices(compat_enc_params: Dict, compat_enc_stats: Dict,
                    flagship_enc_params: Dict,
                    head_key: str = "head_conv") -> Dict[str, Tuple[int, np.ndarray]]:
    """Compute, per block leaf axis, the source-channel selection for every
    channel space whose flagship width is smaller than the compat width.

    Returns {block_name + '/' + leaf_path: list of (axis, idx_array)} gathers
    to apply to the COMPAT leaf before the slab overlay.
    """
    blocks = sorted(
        (k for k in flagship_enc_params
         if re.fullmatch(r"block_\d+", k) and k in compat_enc_params),
        key=lambda s: int(s.split("_")[1]))
    if not blocks:
        return {}

    def widths(enc, stats, b):
        lv = _block_leaves(enc, stats, b)
        e = lv["depthwise_conv/kernel"].shape[3]
        cin = lv["expand_conv/kernel"].shape[2] if "expand_conv/kernel" in lv else e
        cout = lv["project_conv/kernel"].shape[3]
        se = lv["se/reduce/kernel"].shape[3] if "se/reduce/kernel" in lv else None
        return cin, e, cout, se, lv

    src: Dict[str, Tuple] = {b: widths(compat_enc_params, compat_enc_stats, b) for b in blocks}
    dst: Dict[str, Tuple] = {b: widths(flagship_enc_params, {}, b) for b in blocks}

    # --- tie channel spaces: residual chains + e=1 expanded==input
    uf = _UnionFind()
    order = [int(b.split("_")[1]) for b in blocks]
    for j, b in enumerate(blocks):
        cin, e, cout, _, lv = src[b]
        if cin == cout:  # residual block (EfficientNet: in==out => stride 1)
            uf.union(("in", b), ("out", b))
        if "expand_conv/kernel" not in lv:  # e=1: expanded space IS the input space
            uf.union(("exp", b), ("in", b))
        if j + 1 < len(blocks) and order[j + 1] == order[j] + 1:
            uf.union(("out", b), ("in", blocks[j + 1]))

    # --- per-space widths and importance scores
    space_w: Dict[Any, Tuple[int, int]] = {}
    prod: Dict[Any, np.ndarray] = {}
    cons: Dict[Any, np.ndarray] = {}

    def add(d, key, term):
        d[key] = d.get(key, 0.0) + term

    def record_width(key, sw, dw):
        if key in space_w:
            assert space_w[key] == (sw, dw), (key, space_w[key], (sw, dw))
        else:
            space_w[key] = (sw, dw)

    for b in blocks:
        cin_s, e_s, cout_s, se_s, lv = src[b]
        cin_d, e_d, cout_d, se_d, _ = dst[b]
        r_in, r_out, r_exp = uf.find(("in", b)), uf.find(("out", b)), uf.find(("exp", b))
        record_width(r_in, cin_s, cin_d)
        record_width(r_out, cout_s, cout_d)
        record_width(r_exp, e_s, e_d)

        proj = lv["project_conv/kernel"]
        g2 = np.abs(np.asarray(lv.get("bn2/scale", np.ones(cout_s)), np.float32))
        add(prod, r_out, _norm(proj, 3) * g2)

        if "expand_conv/kernel" in lv:
            exp = lv["expand_conv/kernel"]
            add(cons, r_in, _norm(exp, 2))
            # private expanded space: multiplicative along the block's chain
            g0 = np.abs(np.asarray(lv.get("bn0/scale", np.ones(e_s)), np.float32))
            g1 = np.abs(np.asarray(lv.get("bn1/scale", np.ones(e_s)), np.float32))
            score_e = (_norm(exp, 3) * g0 * (_norm(lv["depthwise_conv/kernel"], 3) + 1e-8)
                       * g1 * _norm(proj, 2))
            add(prod, r_exp, score_e)
            add(cons, r_exp, np.ones(e_s, np.float32))
        else:
            # e=1: the depthwise+project chain consumes the input space directly
            g1 = np.abs(np.asarray(lv.get("bn1/scale", np.ones(e_s)), np.float32))
            add(cons, r_in, (_norm(lv["depthwise_conv/kernel"], 3) + 1e-8)
                * g1 * _norm(proj, 2))

        if se_s is not None:
            key = ("se", b)
            record_width(key, se_s, se_d if se_d is not None else se_s)
            add(prod, key, _norm(lv["se/reduce/kernel"], 3)
                + np.abs(np.asarray(lv["se/reduce/bias"], np.float32)))
            add(cons, key, _norm(lv["se/expand/kernel"], 2))

    # the head conv consumes the last block's output space
    last_out = uf.find(("out", blocks[-1]))
    if head_key in compat_enc_params and head_key in flagship_enc_params:
        hk = np.asarray(compat_enc_params[head_key]["kernel"])
        if hk.shape[2] == space_w[last_out][0]:
            add(cons, last_out, _norm(hk, 2))

    idx_of: Dict[Any, Optional[np.ndarray]] = {}
    for key, (sw, dw) in space_w.items():
        if dw >= sw:
            idx_of[key] = None  # grown / unchanged: identity, slab handles the rest
            continue
        p = prod.get(key)
        c = cons.get(key)
        score = ((p if p is not None else np.ones(sw, np.float32)) *
                 (c if c is not None else np.ones(sw, np.float32)))
        idx = np.argsort(-score, kind="stable")[:dw]
        idx.sort()
        idx_of[key] = idx

    # --- per-leaf gather plan (axis -> idx), for leaves of shrunk spaces
    AXES = {  # leaf path -> [(axis, space_kind)]
        "expand_conv/kernel": [(2, "in"), (3, "exp")],
        "depthwise_conv/kernel": [(3, "exp")],
        "project_conv/kernel": [(2, "exp"), (3, "out")],
        "se/reduce/kernel": [(2, "exp"), (3, "se")],
        "se/reduce/bias": [(0, "se")],
        "se/expand/kernel": [(2, "se"), (3, "exp")],
        "se/expand/bias": [(0, "exp")],
        "bn0/scale": [(0, "exp")], "bn0/bias": [(0, "exp")],
        "bn1/scale": [(0, "exp")], "bn1/bias": [(0, "exp")],
        "bn2/scale": [(0, "out")], "bn2/bias": [(0, "out")],
        "stats/bn0/mean": [(0, "exp")], "stats/bn0/var": [(0, "exp")],
        "stats/bn1/mean": [(0, "exp")], "stats/bn1/var": [(0, "exp")],
        "stats/bn2/mean": [(0, "out")], "stats/bn2/var": [(0, "out")],
    }
    plan: Dict[str, List[Tuple[int, np.ndarray]]] = {}
    for b in blocks:
        for path, axes in AXES.items():
            gathers = []
            for ax, kind in axes:
                key = uf.find((kind, b)) if kind != "se" else ("se", b)
                idx = idx_of.get(key)
                if idx is not None:
                    gathers.append((ax, idx))
            if gathers:
                plan[f"{b}/{path}"] = gathers
    hidx = idx_of.get(last_out)
    if hidx is not None and head_key in compat_enc_params:
        plan[f"{head_key}/kernel"] = [(2, hidx)]
    return plan


def _apply_plan(enc_params: Dict, enc_stats: Dict, plan: Dict) -> None:
    """Gather the planned axes in place on the (numpy) compat encoder trees."""

    def gat(tree, parts, gathers):
        node = tree
        for p in parts[:-1]:
            if p not in node:
                return
            node = node[p]
        leaf = node.get(parts[-1])
        if leaf is None:
            return
        arr = np.asarray(leaf)
        for ax, idx in gathers:
            if ax < arr.ndim and arr.shape[ax] > len(idx):
                arr = np.take(arr, idx, axis=ax)
        node[parts[-1]] = arr

    for path, gathers in plan.items():
        parts = path.split("/")
        if "stats" in parts:
            i = parts.index("stats")
            gat(enc_stats, parts[:i] + parts[i + 1:], gathers)
        else:
            gat(enc_params, parts, gathers)


def _as_numpy(tree):
    """A copy of a nested dict with every leaf a numpy array."""
    if isinstance(tree, Mapping):
        return {k: _as_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def flagship_warm_start(compat_variables: Dict, flagship_variables: Dict) -> Dict:
    """Seed flagship (tpu_optimized) variables from reference-exact variables.

    Both arguments are full MammoCLIP variable dicts ({'params', 'batch_stats'}).
    Returns a new dict with the flagship's structure and the compat weights
    overlaid wherever names + shapes allow (see module docstring); the surviving
    channels of every SHRUNK width are picked by magnitude saliency with
    per-space consistency (the JAX module's ``method="importance"``).
    """
    compat = _as_numpy(compat_variables)
    flagship = _as_numpy(flagship_variables)
    c_enc = compat.get("params", {}).get("image_encoder")
    c_sta = compat.get("batch_stats", {}).get("image_encoder", {})
    f_enc = flagship.get("params", {}).get("image_encoder")
    if c_enc and f_enc:
        _apply_plan(c_enc, c_sta, _select_indices(c_enc, c_sta, f_enc))
    return {col: _overlay(compat.get(col, {}), tree)
            for col, tree in flagship.items()}


def warm_start_state_dict(source_state: Mapping, flagship_state: Mapping) -> Dict:
    """``flagship_warm_start`` on the port's state dicts (``MammoCLIP.state_dict()``
    of a reference-exact model and of a flagship one): the seeded flagship state
    dict, fp32, with the flagship's keys and shapes."""
    seeded = flagship_warm_start(variables_from_state_dict(source_state),
                                 variables_from_state_dict(flagship_state))
    return state_dict_from_jax(seeded)
