"""Probe: the hand-written flash attention against the shipped einsum attention
at BERT's shape (port of ``benchmarks/probe_flash_attention.py``).

The question of the JAX probe, asked of the card: does a fused attention,
forward and backward through a scalar loss, beat the shipped matmul + softmax
form at the production text-tower shape (16, 12, 256, 64) bf16? Variants, on
the same seeded inputs (``default_rng(0)``, q, k, v x0.3, the loss weight
x0.1), through the loss ``sum(ctx * w)`` and its gradients in q, k and v. The
product is taken in fp32: the JAX script writes ``sum((ctx * w).astype(f32))``
and XLA's fused multiply keeps it in fp32 (its jitted loss equals the fp32
product's), while a product rounded to bf16 moves this loss by ~1% on its own.

  einsum  ``models/bert.py::attention`` with ``amp_attn_scores`` (bf16 scores,
          fp32 softmax) and an all-ones mask: what the port's BERT runs;
  flash   the hand kernel, ``ops/flash_attention.py`` (``csrc/flash_attention.cu``);
  sdpa    ``torch.nn.functional.scaled_dot_product_attention``, a library call
          timed as a yardstick only: no path of the port calls it.

It prints each variant's loss and gradient norms, the relative difference of
the einsum and flash losses (bf16 tolerance ~1e-2), then each variant's ms per
evaluation (CUDA events on the card; host clock with ``--device cpu``).
``--block-q``, ``--block-k`` and ``--block-b`` are accepted for the JAX
script's command lines and change nothing: the hand kernel's tiles are fixed
(64 queries x 64 keys). ``--inner`` runs that many evaluations per timed call.

Run (card):  python -m mammo_clip_tpu_torch.benchmarks.probe_flash_attention [--iters 50]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..models.bert import attention
from ..ops.flash_attention import flash_attention

B, N, S, D = 16, 12, 256, 64  # production text-tower attention shape
VARIANTS = ("einsum", "flash", "sdpa")


def einsum_attention(q, k, v, mask):
    """The shipped formulation on (B, S, N, D) operands: ``models/bert.py::attention``
    with ``amp_attn_scores`` (the JAX script's ``einsum_attention``)."""
    ctx = attention((q * D ** -0.5).transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask,
                    amp_scores=True)
    return ctx.transpose(1, 2)


def _bnsd(variant, q, k, v):
    """flash or sdpa on (B, S, N, D) operands, through the (B, N, S, D) layout."""
    tq, tk, tv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if variant == "flash":
        out = flash_attention(tq, tk, tv, D ** -0.5)
    else:
        out = F.scaled_dot_product_attention(tq, tk, tv, scale=D ** -0.5)
    return out.transpose(1, 2)


def inputs(device, shape=(B, S, N, D)):
    """q, k, v (x0.3) and the loss weight w (x0.1), bf16, from ``default_rng(0)``."""
    r = np.random.default_rng(0)
    return [torch.from_numpy(r.standard_normal(shape) * s).to(torch.bfloat16).to(device)
            for s in (0.3, 0.3, 0.3, 0.1)]


def build(variant: str, device, shape=(B, S, N, D)):
    """A function that returns (loss, (dq, dk, dv)) of one evaluation."""
    q, k, v, w = inputs(device, shape)
    mask = torch.ones(shape[:2], dtype=torch.bool, device=device)

    def value_and_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        if variant == "einsum":
            ctx = einsum_attention(qq, kk, vv, mask)
        else:
            ctx = _bnsd(variant, qq, kk, vv)
        loss = (ctx.float() * w.float()).sum()
        return loss.detach(), torch.autograd.grad(loss, (qq, kk, vv))

    return value_and_grad


def fwd_value(variant: str, device, shape=(B, S, N, D)):
    loss, grads = build(variant, device, shape)()
    return float(loss), [float(g.float().norm()) for g in grads]


def time_per_eval(fn, device, iters: int, inner: int) -> float:
    """ms per evaluation: CUDA events on the card, the host clock on the CPU."""
    fn()  # warm-up
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
    else:
        start = time.perf_counter()
    for _ in range(iters * inner):
        fn()
    if on_card:
        t1.record()
        torch.cuda.synchronize()
        total = t0.elapsed_time(t1)
    else:
        total = (time.perf_counter() - start) * 1e3
    return total / (iters * inner)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--block-q", type=int, default=256)
    ap.add_argument("--block-k", type=int, default=256)
    ap.add_argument("--block-b", type=int, default=1)
    ap.add_argument("--inner", type=int, default=1,
                    help="fwd+bwd evaluations per timed call")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run with --device cpu to probe the plain versions")

    # numerics first: same inputs, loss + grad-norm agreement at bf16 resolution
    res = {"loss": {}, "grad_norms": {}, "ms": {}}
    for variant in VARIANTS:
        loss, norms = fwd_value(variant, args.device)
        res["loss"][variant], res["grad_norms"][variant] = loss, norms
        note = "  (library call)" if variant == "sdpa" else ""
        print(f"{variant:7s} loss {loss:+.4f}  grad norms {['%.3f' % g for g in norms]}{note}")
    le, lf = res["loss"]["einsum"], res["loss"]["flash"]
    res["rel"] = abs(le - lf) / max(abs(le), 1e-6)
    print(f"loss rel diff {res['rel']:.2e} (bf16 tolerance ~1e-2)")

    for variant in VARIANTS:
        per = time_per_eval(build(variant, args.device), args.device, args.iters, args.inner)
        res["ms"][variant] = per
        note = "  library call, no route of the port" if variant == "sdpa" else ""
        print(f"{variant:7s} {per:7.3f} ms/eval  ({args.iters} calls x {args.inner} inner){note}")
    return res


if __name__ == "__main__":
    main()
