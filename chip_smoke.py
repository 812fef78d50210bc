#!/usr/bin/env python3
"""Card smoke test of the PyTorch/H100 port (``mammo_clip_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py [--seed 0] [--parent DIR]

Phases, each reported on its own lines:
  1. environment: card name and power limit, torch/CUDA versions, build dir state;
  2. build: nvcc over ``mammo_clip_tpu_torch/csrc/*.cu`` (seconds, ptxas summary);
  3. the hand-written ``fused_mbconv_e6`` kernels against their plain PyTorch
     version at the compat B5 step's real shapes (block 4: e=6, C=40, E=240,
     380x228; block 0: e=1, 48->24, 760x456; blocks 1-2: e=1, 24->24 with the
     residual, 760x456; N=2), forward and backward, in fp32 and bf16, each max
     |diff| beside its tolerance;
  4. kernel times (CUDA events) beside the plain version's and the card's bound;
     for each form at each shape (bf16; both forms run the passes of
     csrc/mbconv6_e6.cu) also its device time per pass (torch.profiler), the
     bytes one forward keeps for its backward as the tensors requested them
     and as the caching allocator rounds them (it fails if an e=1 call keeps
     64 KB or more requested), the kernels one forward and one backward launch (the
     library's own and all, by torch.profiler), each of the form's kernels'
     registers, shared and local memory, spill stores and blocks per SM, and
     its HMMA and atomic counts in the SASS (it fails if a kernel with a
     channel product has no HMMA or any kernel has an atomic; the SASS goes to
     chiprun_out/), and two bf16 backward passes on the same inputs, which must
     give the same bits; with ``--parent DIR`` (an older checkout of the port),
     the old and this package's block timed in turns at each shape through
     their public wrappers (``benchmarks/e6_timing.py --turns --case``: old,
     new, new, old processes), with the compat slice's peak memory in the
     first old and new processes of block 4's turns, then the e1 entry point
     at blocks 0 and 1-2, the grid compute, const and base kernels at the
     probe's shape, and the layout and flash wrappers' host cost the same way
     (``e6_timing.py --case block0_e1_entry`` / ``block1_e1_entry``,
     ``layout_timing.py --grid``, ``layout_timing.py``), and the fused, e1
     and grid compute, const and base rows of the kernels line carry the old
     ``earlier_ms`` (the e1 rows' in device time), the flash rows the old
     ``earlier_host_us``, the channel-mix row the old ``earlier_ms``,
     ``earlier_device_ms`` and ``earlier_host_us``;
  5. a small-input reference check (tiny CLIP step on the card with the kernels
     against the same step on the CPU with the plain version), then the slice:
     the full-width compat B5 CLIP (B5 at 1520x912, BERT-base, 256 tokens,
     bf16 activations, fp32 params, fused route on, remat as the recipe sets it)
     takes 3 train steps on a seeded synthetic batch of 2 samples
     (two views, two texts each, augmentation on), with the kernel launch
     counters read around the run;
  6. the e=1 block's own entry point, ``fused_mbconv_e1``, which runs the e=1
     form's passes of csrc/mbconv6_e6.cu over the whole image, against its
     plain version at the two B5 e=1 shapes (block 0: 48->24; blocks 1-2:
     24->24 with the residual; 760x456, N=2, delta [1.25, 0]), forward and
     backward, fp32 and bf16; the same bits as ``fused_mbconv_e6(x, p, delta,
     H, W)`` for out, the stats, dx and every gradient; its path driven once
     through the public wrapper with the counters read around it; the
     library's kernels one call launches (torch.profiler), which must all be
     the e=1 form's; then its times through the wrapper (the kernels line's
     ``ms`` and ``plain_ms`` in device time, the host's enqueue hidden behind
     a sleep kernel; ``event_ms`` CUDA events) beside the plain version's, its
     bound and the e=1 form's phase-4 times, its device time per pass and the
     bytes it holds from forward to backward (requested, under 64 KB, and
     allocated);
  7. the pretraining entry point: ``cli/pretrain.main`` at full width (the
     default B5 config made into the compat recipe by dotted overrides, a CSV
     of 8 rows in a temporary directory, ``synthetic://`` images), 1 epoch of 3
     steps at batch 2 with 1 validation batch, then ``--resume`` for a second
     epoch; it checks the checkpoints, best/, the step count, finite losses,
     14+14 e6 calls per step and that no thread is left behind, and prints the
     per-step ms, the checkpoint write and read seconds, and the kernel time and
     device busy share of its second step, profiled by ``train.profile_at_step``;
     its run directory is kept for phase 10, which runs next;
 10. serving, the evaluation entry points on the card, fp32: (a)
     ``cli/zeroshot`` on phase 7's ``best/`` (32 VinDr-style rows with both
     classes of each label, ``synthetic://`` images at 1520x912), finite AUROCs
     in [0, 1]; (b) ``cli/retrieval`` on it (32 rows, 8 unique reports): each
     Recall@K in [0, 1] and not falling as K grows, 1 <= MeanRank <= 8; (c)
     ``cli/validate`` on phase 7's run: a finite loss for every checkpointed
     step and ``best_step`` their argmin, printed beside the validation loss
     the trainer logged at those steps (bf16 activations there, fp32 here, so
     not gated); (d) a fake reference ``.tar`` at the full B5 shapes
     (``parity/fake_checkpoint.py``, 1520x912, 256 tokens) through
     ``cli/zeroshot``, then that ``.tar`` and ``best/`` each loaded by
     ``load_clip_for_eval`` on the card and on the CPU, 2 images (a synthetic
     one and a ramp) and 2 texts embedded on both: max |diff| of the unit-norm
     embeddings <= 1e-3 with TF32 off (the two inputs' own distance printed
     beside it); (e) ``EmbeddingExtractor`` on (d)'s card model: images/s at
     batch 16 and texts/s at batch 16 x 256 tokens over 4 batches after one
     warm-up batch (host clock around work that ends in a synchronise), peak
     device memory, the phase's seconds, beside the card's name and power
     limit. The fused MBConv launch counters must read 0 over (a)-(e): eval
     takes the unfused blocks, as in the JAX package;
 11. the downstream classifier, on phase 7's run, whose directory is kept
     until this phase ends: (a) ``fused_mbconv_e6`` at the ft arm's shapes,
     block 4 (e6), block 0 (e=1) and blocks 1-2 (e=1 with the residual) at
     N=8 in fp32, against its plain version (out, the stats, dx and every
     gradient, phase 3's fp32 tolerances), its times beside the plain
     version's and the bound (each fp32 product once, at the TF32 peak), and
     its held bytes; (b) one
     ft step of a tiny classifier (b0 at 64x48, fused route on, 2 images) on
     the card with the kernel against the CPU with the plain version, same
     weights: loss and head gradient within 1e-3; (c) ``cli/classifier`` on
     ``best/``, ``--arch lp`` then ``--arch ft``, each ``--epochs 1`` then
     ``--epochs 2 --resume``, on a 52-row RSNA-style CSV of ``synthetic://``
     images at 1520x912 (32 training rows: 4 steps at batch 8; 20 validation
     rows, 16 (patient, laterality) groups with both classes, so the last
     validation batch is padded): the JSON line's ``best_metric`` finite in
     [0, 1], ``best/`` with ``arrays.npz`` holding one prediction per group,
     the resumed run starting at epoch 1 with a history of 2, and the fused
     counters read around every step: 7 forward and 7 backward per ft train
     step, 0 for every lp step and every validation batch; every step with
     TF32 off, though the CLI is entered with torch's default (cuDNN's TF32
     on); (d)
     ``cli/rescore`` on each ``best/``: its ``auroc`` equals the CLI's
     ``best_metric`` within 1e-9; (e) printed, not gated: the train steps'
     ms after step 0 of each run (host clock, ending in a synchronise),
     images/s, the validation batches' ms, peak device memory per arm, the
     checkpoint write seconds and the phase's seconds, beside the card's name
     and power limit;
 12. detection, on phase 7's run, whose directory is kept until this phase
     ends (no hand kernel lies on this path: the detector's backbone runs in
     eval mode, so the fused block never launches): (a) a tiny RetinaNet (b0
     at 64x64, 3 classes, fused route on) on the card against the CPU from
     the same weights, fp32 with TF32 off: class probabilities and deltas
     within 1e-4 of the largest (the card's bf16 forward within 5e-2,
     printed beside them), one ``make_detector_steps`` train step with
     augmentation off (the focal loss's parts within 1e-4, the class head's
     gradient within 1e-3), ``detect`` hard and soft on a seeded candidate
     pool of distinct scores (the same valid slots, classes and scores within
     1e-6, boxes within 1e-4); (b) ``cli/detector`` on ``best/`` at full
     width (B5 at 512x512, batch 7, bf16), ``--epochs 1`` then ``--epochs 2
     --resume``, on a VinDr-style CSV of ``synthetic://`` images with boxes
     (21 training images: 3 steps a run; 9 validation images, so the last
     validation batch is padded, fault R8 of the JAX CLI not inherited):
     finite losses, ``best_mAP`` in [0, 1], ``arrays.npz`` with one slate
     per validation image, the resumed run starting at epoch 1, and the fused
     counters reading 0 around every train and validation step; (c)
     ``--epochs 3 --resume --eval-scales 0.75,1.0,1.25 --soft-nms``: the
     multi-scale soft-NMS validation, the same gates; (d) printed, not gated:
     the train step's ms after step 0 of each run (host clock, ending in a
     synchronise), images/s, ms per validation batch, the NMS's ms per batch
     alone (decode, clip and the per-class NMS), the multi-scale batches'
     ms, peak device memory, checkpoint write seconds and the phase's
     seconds, beside the card's name and power limit;
  8. the hand-written flash attention (csrc/flash_attention.cu): first a look
     into the built library, each flash kernel's registers, shared and local
     memory (``cuobjdump --dump-resource-usage``), spill stores (ptxas) and its
     count of HMMA and atomic instructions in the SASS (it fails if a bf16
     tensor-core kernel has no HMMA or a flash kernel has an atomic; the SASS
     goes to chiprun_out/); then the kernel against its plain version at the
     probe's (16, 12, 256, 64) and a ragged (4, 12, 200, 32), fp32 and bf16,
     out, dq, dk, dv, with SDPA's own distance from the plain version printed
     beside the bf16 rows as a yardstick; its path, the port of
     ``benchmarks/probe_flash_attention.py``, driven once with the counters read
     around it (its einsum-vs-flash loss within 1e-2); the bf16 backward run
     twice on the same inputs, which must give the same bits; then its forward,
     backward and forward+backward times (CUDA events, and device time with the
     host's enqueue hidden behind a sleep kernel) beside the plain version's,
     the port's ``amp_attn_scores`` einsum attention,
     ``scaled_dot_product_attention`` (the library yardstick) and the bound,
     and the host's cost per call of ``flash_attention`` (``host_us``;
     ``layout_timing.flash_calls``), beside the parent's with ``--parent``
     (``earlier_host_us``);
     the kernels line's ``ms``, ``plain_ms`` and ``library_ms`` of these rows
     are all device times, ``event_ms`` the kernel's CUDA-event time;
  9. the probe kernels (csrc/probes.cu): the four grid kernels at the probe's
     (16, 40, 232, 384) bf16 (the const kernel also with its bank cancelled, so
     that the x part is held alone) and
     the three layout kernels at the JAX script's shapes, each through its
     wrapper against its plain version (the grid kernels are timed through
     their raw launchers, uncounted), the layout sums beside what the JAX
     script prints; their path, the port of
     ``benchmarks/probe_mosaic.py`` (all probes), driven once with the counters
     read around it; then their times, us per grid block, and bounds (the
     part that bounds printed; the grid compute kernel's work priced at the
     units its code uses: z and the taps' 0/1-selector sums on the tensor
     cores, the packed bf16 tap products off them), and for
     the grid base and the three layout kernels the time of one PyTorch call of
     the same function (``torch.sum``, ``torch.mm``, ``torch.mul``,
     ``torch.einsum``; each first checked against the plain version; for the
     const kernel, which no single call computes, the time of ``torch.sum``
     of x plus the bank term, ``composite_ms``). Two calls on the same input
     must give the same bits for the Gram, grid compute, const and channel-mix
     kernels. The grid compute kernel is also held to the plain version on
     all E channel sums (its C outputs are their first C). The grid compute,
     const and channel-mix kernels' registers, spills, shared memory, blocks
     per SM and HMMA, atomic and bulk-copy (``UBLKCP``) counts are printed
     (it fails if the compute kernel has no HMMA, any of them an atomic, the
     const kernel's ring no bulk copy, or a const or channel-mix kernel
     spills; the SASS goes to chiprun_out/probes.sass). The device time of
     an empty kernel's launch, the least any launch takes, is printed and
     put beside the layout rows (``empty_device_ms``). The layout kernels and
     their library calls are host-bound at this size, so each gets three
     numbers (``benchmarks/layout_timing.py``, kernel and library trials taken
     in turns): ``ms``, the median CUDA-event time per call of 5 trials of 200
     calls after 20 warm-up calls; ``device_ms``, device time with the host's
     enqueue hidden behind a sleep kernel; ``host_us``, the host's cost per
     call over 1,000 calls with no synchronise between them (on the kernels
     line: ``device_ms``, ``host_us``, ``library_device_ms``,
     ``library_host_us``).
The line before the last is a JSON object with one entry per kernel (e6 entries
counted on the CLI slice, the N=8 fp32 e6 entries on the classifier's ft arm,
e1, flash and probe entries on their own paths); the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside a
checkout of the repository, the script exits non-zero and prints no result.
Long logs go to chiprun_out/.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # dense tensor-core bf16
TF32_FLOPS = 495e12  # dense tensor-core TF32
FP32_FLOPS = 67e12  # fp32 outside the tensor cores
BATCH = 2
STEPS = 3


class SmokeFailure(RuntimeError):
    pass


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if res.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phase 3/4 helpers: one kernel case
# --------------------------------------------------------------------------


class Case:
    """A fused block at its main-path shape: e6 (blocks 4-7) or e1 (blocks 0-2)."""

    def __init__(self, name, form, N, C, C2, vh, vw, seed):
        import torch

        from mammo_clip_tpu_torch.ops.mbconv import MBConvParams
        from mammo_clip_tpu_torch.ops.mbconv6 import MBConv6Params, pick_h_pad, pick_w_pad

        self.name, self.form = name, form
        self.N, self.C, self.C2, self.vh, self.vw = N, C, C2, vh, vw
        self.E = 6 * C if form == "e6" else C
        self.H, self.W = pick_h_pad(vh), pick_w_pad(vw)
        g = torch.Generator(device="cuda").manual_seed(seed)
        f = lambda *s: 0.5 * torch.randn(*s, generator=g, device="cuda")
        E, sq = self.E, max(1, int(C * 0.25))  # SE squeeze from the block's input width
        common = dict(dw_kernel=f(E, 3, 3), gamma1=1 + 0.1 * f(E), beta1=0.1 * f(E),
                      se_w1=f(E, sq) / math.sqrt(E), se_b1=0.1 * f(sq),
                      se_w2=f(sq, E) / math.sqrt(sq), se_b2=0.1 * f(E),
                      wp=f(E, C2) / math.sqrt(E), gamma2=1 + 0.1 * f(C2), beta2=0.1 * f(C2))
        if form == "e6":
            self.params = MBConv6Params(we=f(C, E) / math.sqrt(C), gamma0=1 + 0.1 * f(E),
                                        beta0=0.1 * f(E), **common)
        else:
            self.params = MBConvParams(**common)
        x = torch.zeros(N, C, self.H, self.W, device="cuda")
        x[:, :, :vh, :vw] = torch.randn(N, C, vh, vw, generator=g, device="cuda")
        self.x = x
        self.delta = torch.tensor(([1.0 / 0.8, 1.0] * N)[:N], device="cuda")
        self.gout = torch.zeros(N, C2, self.H, self.W, device="cuda")
        self.gout[:, :, :vh, :vw] = torch.randn(N, C2, vh, vw, generator=g, device="cuda")

    def run(self, fn, dtype):
        """out, stats, dx, parameter grads of ``fn`` (kernel or plain), synced."""
        import torch

        x = self.x.to(dtype).clone().requires_grad_(True)
        p = type(self.params)(*[t.detach().clone().requires_grad_(True) for t in self.params])
        out, stats = fn(x, p, self.delta, self.vh, self.vw)
        out.backward(self.gout.to(dtype))
        torch.cuda.synchronize()
        return out.detach().float(), [s.float() for s in stats], x.grad.float(), \
            [t.grad for t in p]

    def bound(self, direction, dtype_name="bfloat16"):
        """(bound_ms, bound_by, which) for one call: I/O bytes over the HBM
        rate, the channel products over the tensor-core peak for their type
        (bf16, or TF32 for fp32 activations: the card's fastest fp32 product)
        and the depthwise stencil (fp32 sums, off the tensor cores) over the
        fp32 peak. Each product of the function counts once, however many
        the kernel takes for it; in fp32 the activations take 4 bytes."""
        P = self.N * self.H * self.W
        nparam = sum(t.numel() for t in self.params)
        prod = 2 * P * self.E * self.C2 + (2 * P * self.C * self.E if self.form == "e6" else 0)
        stencil = 2 * 9 * P * self.E
        bf16 = dtype_name == "bfloat16"
        item = 2 if bf16 else 4
        if direction == "forward":
            nbytes = item * P * (self.C + self.C2) + 4 * nparam
        else:
            nbytes = item * P * (2 * self.C + self.C2) + 8 * nparam
            prod, stencil = 2 * prod, 2 * stencil
        return bound(nbytes, {"channel products": (prod, BF16_FLOPS if bf16 else TF32_FLOPS),
                              "stencil": (stencil, FP32_FLOPS)})


def max_rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


def pad_max(t, case):
    """Largest |value| outside the valid region (0.0 when there is no pad)."""
    rows = t[:, :, case.vh:].abs().max().item() if case.vh < case.H else 0.0
    cols = t[:, :, :, case.vw:].abs().max().item() if case.vw < case.W else 0.0
    return max(rows, cols)


def e1_fns():
    """fused_mbconv_e1 and its plain version under the Case.run call signature
    (the e1 entry point has no pad region: vh, vw are the full height and width)."""
    from mammo_clip_tpu_torch.ops.mbconv import fused_mbconv_e1, plain_fused_mbconv_e1

    return (lambda x, p, d, vh, vw: fused_mbconv_e1(x, p, d),
            lambda x, p, d, vh, vw: plain_fused_mbconv_e1(x, p, d))


def check_case(case, dtype_name, fns=None):
    """Phase 3 (e6 kernel) or 6 (``fns`` = e1_fns()) for one case and dtype;
    returns the max abs error of out and dx."""
    import torch

    from mammo_clip_tpu_torch.ops.mbconv6 import fused_mbconv_e6, plain_fused_mbconv_e6

    kernel_fn, plain_fn = fns or (fused_mbconv_e6, plain_fused_mbconv_e6)
    dtype = getattr(torch, dtype_name)
    ok, sk, dxk, gk = case.run(kernel_fn, dtype)
    op, sp, dxp, gp = case.run(plain_fn, dtype)
    bf16 = dtype_name == "bfloat16"
    rows = [("out", max_rel(ok, op), 1e-2 if bf16 else 1e-4),
            ("dx", max_rel(dxk, dxp), 1e-2 if bf16 else 1e-3)]
    rows += [(f"stat{i}", max_rel(a, b), 1e-4) for i, (a, b) in enumerate(zip(sk, sp))]
    rows += [(f"d{n}", max_rel(a, b), 2e-3)
             for n, a, b in zip(type(case.params)._fields, gk, gp)]
    pad, dxpad = pad_max(ok, case), pad_max(dxk, case)
    worst = max(rows, key=lambda r: r[1] / r[2])
    say(f"[check] {case.name} {dtype_name}: " + ", ".join(
        f"{n} {e:.2e}/{t:.0e}" for n, e, t in rows))
    say(f"[check] {case.name} {dtype_name}: out pad max {pad}, dx pad max {dxpad}, "
        f"worst {worst[0]} {worst[1]:.2e} (tol {worst[2]:.0e})")
    bad = [r for r in rows if not (r[1] <= r[2])]
    if bad or pad != 0.0 or dxpad != 0.0:
        raise SmokeFailure(f"{case.name} {dtype_name}: kernel disagrees with plain: {bad} "
                           f"pads {pad} {dxpad}")
    return float((ok - op).abs().max()), float((dxk - dxp).abs().max())


def time_ms(fn, reps=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def case_fns(case, dtype_name="bfloat16"):
    """(forward, backward) of the case's form through its pass sequence
    (``_e6_forward`` / ``_e6_backward`` or ``_e1_forward`` / ``_e1_backward``),
    bf16 unless asked, the backward on one forward's statistics and kept vectors."""
    import torch

    from mammo_clip_tpu_torch.ops import mbconv6

    fwd_fn, bwd_fn = ((mbconv6._e6_forward, mbconv6._e6_backward) if case.form == "e6"
                      else (mbconv6._e1_forward, mbconv6._e1_backward))
    dtype = getattr(torch, dtype_name)
    x, g = case.x.to(dtype), case.gout.to(dtype)
    args = (x, case.params, case.delta, case.vh, case.vw, 1e-3)
    _, stats, kept = fwd_fn(*args)
    return (lambda: fwd_fn(*args)), (lambda: bwd_fn(*args, g, stats, kept))


def time_case(case, dtype_name="bfloat16", reps=10):
    """Phase 4 (bf16, the main path's type; phase 11 fp32): forward and backward
    ms of the form's passes and of the plain version."""
    import torch

    from mammo_clip_tpu_torch.ops.mbconv6 import plain_fused_mbconv_e6

    dtype = getattr(torch, dtype_name)
    x = case.x.to(dtype)
    g = case.gout.to(dtype)
    p = case.params
    args = (x, p, case.delta, case.vh, case.vw, 1e-3)
    fwd, bwd = case_fns(case, dtype_name)
    with torch.no_grad():
        k_fwd, k_bwd = time_ms(fwd, reps), time_ms(bwd, reps)
        p_fwd = time_ms(lambda: plain_fused_mbconv_e6(*args), reps)
    xr = x.clone().requires_grad_(True)
    pr = type(p)(*[t.clone().requires_grad_(True) for t in p])
    out, _ = plain_fused_mbconv_e6(xr, pr, case.delta, case.vh, case.vw)
    p_bwd = time_ms(lambda: torch.autograd.grad(out, [xr, *pr], g, retain_graph=True), reps)
    return k_fwd, k_bwd, p_fwd, p_bwd


def held_bytes(fn, case, dtype_name="bfloat16"):
    """Device bytes that one forward of ``fn`` (bf16 unless asked) keeps for its backward beyond
    its inputs and outputs (the saved intermediates), as (allocated, requested):
    ``memory_allocated()`` counts the caching allocator's blocks, which round a
    large output up to whole 2 MiB pages once or twice by the allocator's state;
    ``requested_bytes.all.current`` counts the bytes the tensors asked for, which
    the allocator's state does not move. Each less the outputs' bytes."""
    import torch

    requested = lambda: torch.cuda.memory_stats().get("requested_bytes.all.current", 0)
    x = case.x.to(getattr(torch, dtype_name), copy=True).requires_grad_(True)
    p = type(case.params)(*[t.detach().clone().requires_grad_(True) for t in case.params])
    torch.cuda.synchronize()
    base, base_req = torch.cuda.memory_allocated(), requested()
    out, stats = fn(x, p, case.delta, case.vh, case.vw)
    torch.cuda.synchronize()
    outputs = sum(t.numel() * t.element_size() for t in (out, *stats))
    return (torch.cuda.memory_allocated() - base - outputs, requested() - base_req - outputs)


HELD_LIMIT = 65536  # bytes an e=1 call may keep from forward to backward (requested)


def check_held(tag, name, held):
    """Print both counts of held_bytes; fail an e=1 call that keeps 64 KB or more
    of requested bytes."""
    allocated, requested = held
    say(f"[{tag} memory] {name} bf16: held from forward to backward beyond x and the "
        f"outputs: {requested} B requested ({allocated} B allocated)")
    if requested >= HELD_LIMIT:
        raise SmokeFailure(f"{name}: the e=1 block keeps {requested} B from forward to backward")


def kernel_phases(seed):
    """Phases 3 and 4 for each main-path shape. Returns one row per case and
    direction, and for the e=1 cases the e=1 form's (forward, backward) ms; the
    cases' device tensors are freed on return, so the slice's
    peak memory counts only the slice."""
    cases = [Case("block4_e6", "e6", BATCH, 40, 40, 380, 228, seed),
             Case("block0_e1", "e1", BATCH, 48, 24, 760, 456, seed + 1),
             Case("block1_e1", "e1", BATCH, 24, 24, 760, 456, seed + 2)]
    errs = {}
    for case in cases:
        for dt in ("float32", "bfloat16"):
            errs[case.name, dt] = check_case(case, dt)
    kernels = []
    for case in cases:  # times in bf16, the main path's type
        k_fwd, k_bwd, p_fwd, p_bwd = time_case(case)
        case.times = (k_fwd, k_bwd)
        for direction, ms, plain in (("forward", k_fwd, p_fwd), ("backward", k_bwd, p_bwd)):
            bound_ms, bound_by, which = case.bound(direction)
            say(f"[time] {case.name} {direction} bf16 N={case.N} {case.H}x{case.W}: kernel "
                f"{ms:.3f} ms, plain {plain:.3f} ms, bound {bound_ms:.4f} ms ({which})")
            kernels.append(dict(case=case.name, form=case.form, direction=direction,
                                err=errs[case.name, "bfloat16"], ms=ms, plain_ms=plain,
                                bound_ms=bound_ms, bound_by=bound_by))
    from mammo_clip_tpu_torch.ops import cuda_lib

    sass = library_report(cuda_lib.build_info.path, cuda_lib.build_info.ptxas, e6_label,
                          "mbconv6_e6.sass")
    for case in cases:
        form_report(case, sass)
    return kernels, {c.name: c.times for c in cases if c.form == "e1"}


def e6_label(mangled):
    """'sweep<bf16,8,3>', 'bwd_x<float,4>', 'bn0', 'sum_blocks' for a kernel of
    csrc/mbconv6_e6.cu, from its mangled name, with ',e1' last for the e=1
    form's instances ('sweep<bf16,8,3,e1>'); None for any other kernel."""
    if "sum_blocks_kernel" in mangled:
        return "sum_blocks"
    m = re.search(r"\d(sweep|bwd_v|bwd_x|moments|out|dx_pad|dx|prep1|prep|bn0)_kernel(I.*?EE)?.*P6",
                  mangled)
    if not m:
        return None
    targs = m.group(2)
    if not targs:
        return m.group(1)
    args = ["bf16" if "bfloat16" in targs else "float"] + re.findall(r"Li(\d+)E", targs)
    return f"{m.group(1)}<{','.join(args + (['e1'] if 'Lb0E' in targs else []))}>"


# A form's kernels in e6_label's names: the e6 form's have no ',e1' (its pass
# kernels and the moments, bn0, dx and prep kernels); the e=1 form's pass kernels
# end in ',e1>' and it shares out and sum_blocks, and adds prep1 and dx_pad.
def form_kernels(labels, form):
    if form == "e6":
        return [k for k in labels if not k.endswith(",e1>") and not k.startswith(("prep1", "dx_pad"))]
    return [k for k in labels if k.endswith(",e1>") or k.startswith(("prep1", "dx_pad", "out",
                                                                      "sum_blocks"))]


def product_kernels(labels, form):
    """The form's kernels with a channel product on the tensor cores: all pass
    kernels but the F3 sweep (d -> v, no product); for the e=1 form also not
    the F2 sweep (the stencil and d's sums)."""
    kinds = ("sweep", "bwd_v", "bwd_x") + (("moments", "dx<") if form == "e6" else ())
    out = []
    for k in form_kernels(labels, form):
        if not k.startswith(kinds):
            continue
        mode = re.match(r"sweep<\w+,\d+,(\d)", k)
        if mode and mode.group(1) in (("2",) if form == "e6" else ("1", "2")):
            continue
        out.append(k)
    return out


def form_report(case, sass):
    """Phase 4's look at one form at one shape in bf16: device time per pass,
    held bytes, kernels per call, the form's kernels' resources and SASS
    (``sass``: library_report's), and a bit-identical backward."""
    import ctypes

    import torch

    from mammo_clip_tpu_torch.benchmarks.e6_timing import kernels_of, launch_counts
    from mammo_clip_tpu_torch.ops import cuda_lib
    from mammo_clip_tpu_torch.ops.mbconv6 import fused_mbconv_e6

    tag = "e6" if case.form == "e6" else "e6 e=1"
    fwd, bwd = case_fns(case)
    say(f"[{tag} passes] {case.name} bf16, device us per forward: " + pass_breakdown(fwd))
    say(f"[{tag} passes] {case.name} bf16, device us per backward: " + pass_breakdown(bwd))
    (hf, af), (hb, ab) = launch_counts(kernels_of(fwd)), launch_counts(kernels_of(bwd))
    say(f"[{tag} launches] {case.name}: kernels per forward {hf} of the library, {af} in all; "
        f"per backward {hb} of the library, {ab} in all (torch.profiler)")
    held = held_bytes(fused_mbconv_e6, case)
    if case.form == "e1":
        check_held(tag, case.name, held)
    else:
        say(f"[{tag} memory] {case.name} bf16: held from forward to backward beyond x and the "
            f"outputs: {held[1]} B requested ({held[0]} B allocated)")
    first, second = bwd(), bwd()
    torch.cuda.synchronize()
    a, b = [first[0], *first[1]], [second[0], *second[1]]
    same = [torch.equal(u, v) for u, v in zip(a, b)]
    say(f"[{tag} check] {case.name} bf16 backward twice on the same inputs: dx and the "
        f"{len(a) - 1} parameter gradients bit-identical: {all(same)}")
    if not all(same):
        raise SmokeFailure(f"{case.name} backward is not deterministic: {same}")

    lib = cuda_lib.load()
    expand = int(case.form == "e6")
    info = {}
    for name, pid in (("moments", 0), ("sweep F2", 1), ("sweep F3", 2), ("sweep F4", 3),
                      ("sweep B1", 4), ("bwd_v", 6), ("bwd_x", 7))[1 - expand:]:
        smem, blocks = ctypes.c_int(), ctypes.c_int()
        rc = lib.m6_kernel_info(pid, expand, 1, case.C, ctypes.byref(smem), ctypes.byref(blocks))
        if rc:
            raise SmokeFailure(f"m6_kernel_info({name}) failed with CUDA error {rc}")
        info[name] = (smem.value, blocks.value)
    say(f"[{tag} kernels] bf16 dynamic shared memory B, blocks per SM: " + ", ".join(
        f"{k} {v[0]} / {v[1]}" for k, v in info.items()))
    usage, counts, spills = sass
    labels = form_kernels(counts, case.form)
    for label in sorted(labels):
        u = usage.get(label, {})
        say(f"[{tag} kernels] {label}: REG {u.get('REG')}, SHARED {u.get('SHARED')}, STACK "
            f"{u.get('STACK')}, LOCAL {u.get('LOCAL')}, spill stores "
            f"{spills.get(label, 'not read (built earlier)')} B, HMMA {counts[label][0]}, "
            f"atomics {counts[label][1]}")
    products = product_kernels(counts, case.form)
    missing = [k for k in products if counts[k][0] == 0]
    atomics = [k for k in labels if counts[k][1]]
    if len(products) != (14 if expand else 8) or missing or atomics:
        raise SmokeFailure(f"{case.name} SASS: kernels with a channel product {sorted(products)}, "
                           f"without HMMA {missing}, with atomics {atomics}")


def parent_turns(parent):
    """The parent's fused block against this one's at each phase-4 shape (bf16),
    and the e1 entry point at blocks 0 and 1-2, through their public wrappers,
    old, new, new, old, one process each (``benchmarks/e6_timing.py --turns
    --case``); the first old and new processes of block 4's turns also run the
    compat slice for its peak memory. Then the grid compute chain, const and
    base kernels through their public wrappers (``benchmarks/layout_timing.py
    --grid``), and the layout wrappers (channel mix: ms, device ms, host us)
    and the flash wrapper's host cost per call (``layout_timing.py``), in the
    same turns. Returns {case: {forward, backward: the old CUDA-event ms,
    forward_device, backward_device: the old device ms}}, the peaks, the old
    grid_compute, grid_const and grid_base ms, {"flash": {forward, backward:
    the old host us}} and {"channel_mix": the old ms, device_ms, host_us}."""
    from mammo_clip_tpu_torch.benchmarks import e6_timing

    earlier = {}
    for case in ("block4_e6", "block0_e1", "block1_e1", "block0_e1_entry", "block1_e1_entry"):
        lines = e6_timing.turns(parent.resolve(), with_slice=case == "block4_e6", case=case)
        side = lambda s: [ln for ln in lines if ln["side"] == s]
        mid = lambda s, k: sum(ln[k] for ln in side(s)) / len(side(s))
        for s in ("old", "new"):
            peaks = side(s)[0].get("slice_peak_bytes")
            say(f"[turns] {case} {s}: fwd ms {[round(ln['fwd_ms'], 4) for ln in side(s)]}, bwd ms "
                f"{[round(ln['bwd_ms'], 4) for ln in side(s)]}, device fwd ms "
                f"{[round(ln['fwd_device_ms'], 4) for ln in side(s)]}, bwd ms "
                f"{[round(ln['bwd_device_ms'], 4) for ln in side(s)]}, held B {side(s)[0]['held_bytes']} "
                f"(requested {side(s)[0]['held_requested_bytes']}, saved "
                f"{side(s)[0]['saved_bytes']}), kernels per forward "
                f"{side(s)[0]['hand_fwd']} of the library / {side(s)[0]['all_fwd']} in all, per "
                f"backward {side(s)[0]['hand_bwd']} / {side(s)[0]['all_bwd']}"
                + (f", slice peaks B {peaks}" if peaks else ""))
        earlier[case] = dict(forward=mid("old", "fwd_ms"), backward=mid("old", "bwd_ms"),
                             forward_device=mid("old", "fwd_device_ms"),
                             backward_device=mid("old", "bwd_device_ms"))
        if case == "block4_e6":
            earlier["old_peak"] = max(side("old")[0]["slice_peak_bytes"])
            earlier["new_peak"] = max(side("new")[0]["slice_peak_bytes"])
    from mammo_clip_tpu_torch.benchmarks import layout_timing

    records = layout_timing.turns(parent.resolve(), grid=True)
    for name in ("grid_compute", "grid_const", "grid_base"):
        ms = [round(r[name]["ms"], 4) for r in records]
        say(f"[turns] {name} (probe_grid[{name[5:]}], through probes.{name}) ms: old "
            f"{[ms[0], ms[3]]}, new {ms[1:3]}")
        earlier[name] = (ms[0] + ms[3]) / 2
    records = layout_timing.turns(parent.resolve())
    old = lambda key, field: (records[0][key][field] + records[3][key][field]) / 2
    earlier["flash"] = {d: old(f"flash.{d}", "host_us") for d in ("forward", "backward")}
    earlier["channel_mix"] = {f: old("channel_mix", f) for f in ("ms", "device_ms", "host_us")}
    say(f"[turns] channel_mix device ms: old {[records[i]['channel_mix']['device_ms'] for i in (0, 3)]},"
        f" new {[records[i]['channel_mix']['device_ms'] for i in (1, 2)]}; empty kernel device ms "
        f"(new only) {[records[i]['empty']['device_ms'] for i in (1, 2)]}")
    return earlier


# --------------------------------------------------------------------------
# phase 5: small reference check and the slice
# --------------------------------------------------------------------------


def synthetic_batch(cfg, n, seed, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    h, w, s = cfg.data.image_size_h, cfg.data.image_size_w, cfg.data.text_max_length
    vocab = cfg.model.text_encoder.vocab_size
    g = torch.Generator(device=device).manual_seed(seed)
    batch = {"images": 255 * torch.rand(n, h, w, 1, generator=g, device=device),
             "image_views": 255 * torch.rand(n, h, w, 1, generator=g, device=device)}
    for suffix in ("", "2"):
        ids = rng.integers(1, vocab, size=(n, s))
        lengths = rng.integers(s // 8, s + 1, size=n)
        mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int64)
        batch["input_ids" + suffix] = torch.tensor(ids * mask, device=device)
        batch["attention_mask" + suffix] = torch.tensor(mask, device=device)
    return batch


def reference_check(seed):
    """One train-mode forward/backward of the tiny CLIP (b0 at 64x64, fused route
    on): kernels on the card against the plain version on the CPU, same weights."""
    import torch

    from mammo_clip_tpu_torch.core.config import tiny_test_config
    from mammo_clip_tpu_torch.losses import build_loss
    from mammo_clip_tpu_torch.models import build_model
    from mammo_clip_tpu_torch.ops.mbconv import launches

    cfg = tiny_test_config()
    cfg.model.image_encoder.fused_mbconv = True
    cfg.model.image_encoder.drop_connect_rate = 0.0
    cfg.model.text_encoder.dropout_rate = 0.0
    loss_fn = build_loss(cfg.loss.to_dict())
    results = []
    for device in ("cuda", "cpu"):
        gen = torch.Generator(device="cpu").manual_seed(seed)
        model = build_model(cfg.model.to_dict(), device="cpu", generator=gen).to(device)
        batch = {k: v.to(device) for k, v in synthetic_batch(cfg, 4, seed, "cpu").items()}
        for k in ("images", "image_views"):
            batch[k] = (batch[k] - 128.0) / 64.0
        before = launches.total("mbconv6", "forward")
        out = model(batch, train=True)
        loss = loss_fn(out, batch, True)["total"]
        loss.backward()
        grads = torch.cat([p.grad.flatten().cpu() for p in model.parameters()])
        results.append((loss.item(), out["image_embeddings"].detach().cpu(), grads,
                        launches.total("mbconv6", "forward") - before))
    (lk, ek, gk, nk), (lp, ep, gp, npl) = results
    err_e = float((ek - ep).abs().max())
    err_g = float((gk - gp).norm() / gp.norm())
    say(f"[reference] tiny CLIP step, kernels (card) vs plain (CPU): loss {lk:.6f} vs "
        f"{lp:.6f}, embeddings max|diff| {err_e:.2e} (tol 1e-3), grads rel {err_g:.2e} "
        f"(tol 1e-3), kernel forward calls {nk} (card) / {npl} (CPU)")
    if not (abs(lk - lp) <= 1e-3 * max(1.0, abs(lp)) and err_e <= 1e-3 and err_g <= 1e-3
            and nk > 0 and npl == 0):
        raise SmokeFailure("tiny CLIP step on the card disagrees with the CPU reference")


def run_slice(seed):
    import torch

    from mammo_clip_tpu_torch.ops.mbconv import launches
    from mammo_clip_tpu_torch.train.recipes import bench_recipe_config, build_bench_train

    cfg = bench_recipe_config(compat=True)
    t0 = time.perf_counter()
    model, _, state, _, train_step = build_bench_train(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[slice] compat B5 CLIP built in {time.perf_counter() - t0:.1f} s: {n_params} params, "
        f"images {cfg.data.image_size_h}x{cfg.data.image_size_w}, "
        f"{cfg.data.text_max_length} tokens, fused_mbconv "
        f"{cfg.model.image_encoder.fused_mbconv}, remat {cfg.model.image_encoder.remat}")
    batch = synthetic_batch(cfg, BATCH, seed, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    launches.reset()
    per_step, rows = [], []
    for i in range(STEPS):
        torch.cuda.reset_peak_memory_stats()
        f0, b0 = launches.total("mbconv6", "forward"), launches.total("mbconv6", "backward")
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, loss = train_step(state, batch, gen)
        total = float(loss["total"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        mem = torch.cuda.max_memory_allocated()
        nf = launches.total("mbconv6", "forward") - f0
        nb = launches.total("mbconv6", "backward") - b0
        per_step.append((nf, nb))
        rows.append({"step": i, "loss": total, "ms": ms, "peak_bytes": mem})
        say(f"[slice] step {i}: loss {total:.6f}, {ms:.1f} ms, peak memory {mem} B "
            f"({mem / 2**30:.2f} GiB), kernel calls fwd {nf} bwd {nb}")
        if not math.isfinite(total):
            raise SmokeFailure(f"step {i}: loss is not finite")
    say(f"[slice] launch counters after {STEPS} steps: {launches.counts}")
    if len(per_step) != STEPS or any(c != (14, 14) for c in per_step):
        raise SmokeFailure(f"expected 14 forward and 14 backward kernel calls per step, "
                           f"got {per_step}")
    from mammo_clip_tpu_torch.ops.augment import minmax_standardize

    with torch.no_grad():
        images = minmax_standardize(batch["images"], cfg.data.mean, cfg.data.std)
        emb = model.embed_image(images, train=False)
    if emb.shape != (BATCH, cfg.model.projection_head.proj_dim) or not torch.isfinite(emb).all():
        raise SmokeFailure(f"eval embeddings malformed: {tuple(emb.shape)}")
    say(f"[slice] eval image embeddings {tuple(emb.shape)} finite, unit norm "
        f"{float(emb.norm(dim=-1).min()):.6f}..{float(emb.norm(dim=-1).max()):.6f}")
    return rows


# --------------------------------------------------------------------------
# phase 6: the standalone e1 kernel
# --------------------------------------------------------------------------


def e1_phases(seed, e6_e1_form):
    """Phase 6: fused_mbconv_e1, which runs the e=1 form's passes of
    csrc/mbconv6_e6.cu over the whole image, against its plain version at B5
    blocks 0 and 1-2; the same bits as fused_mbconv_e6(x, p, delta, H, W); its
    own path through the public wrapper (counters at 0 before, read after), and
    the kernels one call launches, which must all be the e=1 form's; then its
    times through the wrapper (device time, the host's enqueue hidden behind a
    sleep kernel, and CUDA-event time) beside the plain version's, its bound
    and the e=1 form's phase-4 times, its device time per pass and its held
    bytes."""
    import torch

    from mammo_clip_tpu_torch.benchmarks.layout_timing import device_ms
    from mammo_clip_tpu_torch.ops.mbconv import fused_mbconv_e1, launches, plain_fused_mbconv_e1

    # named apart from phase 3's e6 cases of the same shapes (block0_e1, block1_e1)
    cases = [Case("block0", "e1", BATCH, 48, 24, 760, 456, seed + 1),
             Case("block1", "e1", BATCH, 24, 24, 760, 456, seed + 2)]
    for c in cases:  # one image kept and scaled, one dropped
        c.delta = torch.tensor([1.25, 0.0], device="cuda")
    fns = e1_fns()
    errs = {(c.name, dt): check_case(c, dt, fns) for c in cases
            for dt in ("float32", "bfloat16")}
    for c in cases:
        e1_same_bits(c)

    bf16 = torch.bfloat16
    launches.reset()
    for c in cases:
        x = c.x.to(bf16).requires_grad_(True)
        p = type(c.params)(*[t.detach().clone().requires_grad_(True) for t in c.params])
        out, _ = fused_mbconv_e1(x, p, c.delta)
        out.backward(c.gout.to(bf16))
        torch.cuda.synchronize()
        if not (torch.isfinite(out).all() and torch.isfinite(x.grad).all()):
            raise SmokeFailure(f"e1 path {c.name}: non-finite output or gradient")
    counts = dict(launches.counts)
    say(f"[e1 path] fused_mbconv_e1 forward+backward at {[c.name for c in cases]} (bf16): "
        f"counters {counts}")
    want = {**dict.fromkeys(counts, 0), "mbconv1.forward": len(cases),
            "mbconv1.backward": len(cases)}
    if counts != want:
        raise SmokeFailure(f"e1 path: expected {len(cases)} e1 calls each way and no other, "
                           f"got {counts}")

    rows = []
    for c in cases:
        x, g, p = c.x.to(bf16), c.gout.to(bf16), c.params
        e1_form_kernels_only(c.name, f"{c.name}_e1_entry")
        check_held("e1", c.name, held_bytes(fns[0], c))
        xr = x.clone().requires_grad_(True)
        pr = type(p)(*[t.clone().requires_grad_(True) for t in p])
        out, _ = fused_mbconv_e1(xr, pr, c.delta)
        fwd = lambda: fused_mbconv_e1(x, p, c.delta)
        bwd = lambda: torch.autograd.grad(out, [xr, *pr], g, retain_graph=True)
        with torch.no_grad():
            k_fwd, d_fwd = time_ms(fwd), device_ms(fwd)
            p_fwd = device_ms(lambda: plain_fused_mbconv_e1(x, p, c.delta))
        k_bwd, d_bwd = time_ms(bwd), device_ms(bwd)
        outp, _ = plain_fused_mbconv_e1(xr, pr, c.delta)
        p_bwd = device_ms(lambda: torch.autograd.grad(outp, [xr, *pr], g, retain_graph=True))
        del outp
        e6_fwd, e6_bwd = e6_e1_form[c.name + "_e1"]
        for direction, ms, dev, plain, e6_ms in (("forward", k_fwd, d_fwd, p_fwd, e6_fwd),
                                                 ("backward", k_bwd, d_bwd, p_bwd, e6_bwd)):
            bound_ms, bound_by, which = c.bound(direction)
            say(f"[e1 time] {c.name} {direction} bf16 N={c.N} {c.H}x{c.W}: fused_mbconv_e1 "
                f"device {dev:.4f} ms (CUDA events {ms:.4f} ms), plain device {plain:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({which}), the e=1 form's passes in phase 4 "
                f"{e6_ms:.4f} ms (CUDA events)")
            rows.append(dict(case=c.name, direction=direction, err=errs[c.name, "bfloat16"],
                             ms=dev, event_ms=ms, plain_ms=plain, bound_ms=bound_ms,
                             bound_by=bound_by, launches=counts[f"mbconv1.{direction}"]))
        del out
    return rows


def e1_same_bits(case):
    """fused_mbconv_e1 and fused_mbconv_e6 over the whole image (valid_h = H,
    valid_w = W) on the same bf16 inputs: out, the stats, dx and every parameter
    gradient must be the same bits."""
    import torch

    from mammo_clip_tpu_torch.ops.mbconv import fused_mbconv_e1
    from mammo_clip_tpu_torch.ops.mbconv6 import fused_mbconv_e6

    runs = [case.run(fn, torch.bfloat16) for fn in (
        lambda x, p, d, vh, vw: fused_mbconv_e1(x, p, d),
        lambda x, p, d, vh, vw: fused_mbconv_e6(x, p, d, case.H, case.W))]
    flat = [[r[0], *r[1], r[2], *r[3]] for r in runs]
    same = [torch.equal(a, b) for a, b in zip(*flat)]
    say(f"[e1 check] {case.name} bf16: fused_mbconv_e1 against fused_mbconv_e6(x, p, delta, "
        f"{case.H}, {case.W}): out, 4 stats, dx and {len(case.params)} parameter gradients "
        f"bit-identical: {all(same)}")
    if not all(same):
        raise SmokeFailure(f"{case.name}: fused_mbconv_e1 and the e=1 form differ: {same}")


E1_FORM_KERNELS = ("sweep", "bwd_v", "bwd_x", "out", "sum_blocks", "prep1", "dx_pad")


def e1_form_kernels_only(name, case):
    """Fails unless every kernel of the package's own library that one forward
    and one backward through fused_mbconv_e1 launch is one of the e=1 form's
    kernels of csrc/mbconv6_e6.cu (its pass kernels with EXPAND false, and the
    kernels it shares or adds); prints them with their launches and device us
    per pass. The trace comes from a process of its own (``e6_timing.py --case
    case``, this checkout, the same shape): minutes into this script on an H100
    (torch 2.11) torch.profiler kept only part of a call's kernels, or none,
    while every fresh process traced them all."""
    from mammo_clip_tpu_torch.benchmarks import e6_timing

    rec = e6_timing.run_process(ROOT, case)
    times = {}
    for kernels in (rec["kernels_fwd"], rec["kernels_bwd"]):
        for n, (calls, us) in kernels.items():
            c0, t0 = times.get(n, (0, 0.0))
            times[n] = (c0 + calls, t0 + us)
    seen, bad = {}, []
    for n, (calls, _) in times.items():
        if not re.match(r"(void )?\(anonymous namespace\)::", n):
            continue  # a kernel of PyTorch's, not of the package's library
        m = re.search(r"::(\w+)_kernel(<[^()]*>)?", n)
        base = m.group(1) if m else n
        ok = base in E1_FORM_KERNELS and (base not in ("sweep", "bwd_v", "bwd_x")
                                          or m.group(2).rstrip().endswith("false>"))
        key = pass_name(n) + ("" if ok else " (not the e=1 form's)")
        seen[key] = seen.get(key, 0) + calls
        if not ok:
            bad.append(n)
    say(f"[e1 kernels] {name}: the library's kernels of one forward and one backward through "
        f"fused_mbconv_e1 ({case}, a process of its own): "
        + ", ".join(f"{k} x{v}" for k, v in sorted(seen.items())))
    say(f"[e1 passes] {name} bf16, device us per forward+backward through the wrapper: "
        + breakdown(times, calls=1))
    if bad or not seen:
        raise SmokeFailure(f"{name}: fused_mbconv_e1 launched other kernels: {bad or 'none'}")


# --------------------------------------------------------------------------
# phase 7: the pretraining entry point
# --------------------------------------------------------------------------


def kernel_times(events):
    """{kernel name: (calls, total device us)} from profiler trace events."""
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            n, t = out.get(e["name"], (0, 0.0))
            out[e["name"]] = (n + 1, t + e["dur"])
    return out


def short_name(name):
    """A kernel's function name without its namespace and template arguments."""
    m = re.search(r"(\w+_kernel)", name)
    return m.group(1) if m else name[:40]


def pass_name(name):
    """short_name, with the pass of csrc/mbconv6_e6.cu's sweep kernel named."""
    m = re.search(r"sweep_kernel<[^>]*?(\d+), (?:true|false)>", name)
    return f"sweep_{dict(enumerate(('', 'F2', 'F3', 'F4', 'B1')))[int(m.group(1))]}" if m \
        else short_name(name)


TRACED_CALLS = 3


def traced_kernels(fn, calls=TRACED_CALLS):
    """{kernel name: (launches, total device us)} of ``calls`` calls of ``fn``
    (after one untraced call), from torch.profiler's trace."""
    import tempfile

    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(f"{d}/trace.json")
        events = json.loads(Path(f"{d}/trace.json").read_text())["traceEvents"]
    return kernel_times(events)


def breakdown(times, calls=TRACED_CALLS):
    """A trace's kernels ({name: (launches, device us)} of ``calls`` calls) as
    device us per call of each pass, the largest 8."""
    per = {}
    for name, (n, t) in times.items():
        key = pass_name(name)
        per[key] = per.get(key, 0.0) + t / calls
    top = sorted(per.items(), key=lambda kv: -kv[1])
    return f"total {sum(per.values()):.1f}: " + ", ".join(f"{k} {v:.1f}" for k, v in top[:8])


def pass_breakdown(fn):
    """Device time per call of each kernel ``fn`` launches, from torch.profiler."""
    return breakdown(traced_kernels(fn))


def step_trace_summary(path):
    """Kernel time of a profiled train step: device busy share between its first
    and last kernel, and the kernels that take the most time."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    start = min(e["ts"] for e in kernels)
    span = max(e["ts"] + e["dur"] for e in kernels) - start
    busy = sum(e["dur"] for e in kernels)
    top = sorted(kernel_times(kernels).items(), key=lambda kv: -kv[1][1])
    return span, busy, top


def write_pretrain_csv(path, n):
    """n patient rows with two views and two reports each; fold = i % 4."""
    import csv

    cols = ["patient_id", "laterality", "image", "view", "CC", "MLO", "text",
            "text_augment", "fold"]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for i in range(n):
            w.writerow([f"p{i}", "L", str([f"i{i}a.png", f"i{i}b.png"]), str(["CC", "MLO"]),
                        str([f"i{i}a.png"]), str([f"i{i}b.png"]),
                        str([f"there is a mass in sample {i}.", f"impression {i}."]),
                        str([f"a mass in sample {i}.", f"imp {i}."]), i % 4])


def run_cli(seed):
    """``cli/pretrain.main`` at full width: 1 epoch of 3 steps (6 train rows, batch
    2; 2 validation rows in fold 0), then ``--resume`` for a second epoch.
    Returns (numbers, its temporary directory): the run under ``<dir>/run`` is
    phase 10's input, and the caller removes the directory (here only on failure)."""
    import tempfile
    import threading

    import torch

    from mammo_clip_tpu_torch.cli import pretrain
    from mammo_clip_tpu_torch.ops.mbconv import launches
    from mammo_clip_tpu_torch.train import trainer as trainer_mod
    from mammo_clip_tpu_torch.train.recipes import bench_recipe_config

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    seconds = {"write": [], "read": []}
    save0, restore0 = trainer_mod.save_checkpoint, trainer_mod.restore_checkpoint

    def timed(fn, key):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            seconds[key].append(time.perf_counter() - t)
            return out
        return wrapped

    trainer_mod.save_checkpoint = timed(save0, "write")
    trainer_mod.restore_checkpoint = timed(restore0, "read")
    try:
        csv_path = tmp / "pretrain.csv"
        write_pretrain_csv(csv_path, 8)
        entry = json.dumps([{"csv": str(csv_path), "image_dir": "synthetic://",
                             "data_type": "imagetext"}])
        workdir = tmp / "run"
        flags = ["--workdir", str(workdir), "--device", "cuda"]
        overrides = ["model.image_encoder.remat=true", "model.image_encoder.fused_mbconv=true",
                     f"data.train={entry}", f"data.valid={entry}",
                     f"data.batch_size_per_device={BATCH}", "scheduler.warmup_epochs=0",
                     "train.log_every=1", f"seed={seed}"]
        # run 1 records a torch.profiler trace of its second step (train.profile_at_step)
        profile = ["train.profile_at_step=1", "train.profile_num_steps=1"]
        launches.reset()
        for epochs in (1, 2):
            f0, b0 = launches.total("mbconv6", "forward"), launches.total("mbconv6", "backward")
            t = time.perf_counter()
            state = pretrain.main(flags + (["--resume"] if epochs == 2 else profile)
                                  + overrides + [f"scheduler.epochs={epochs}"])
            torch.cuda.synchronize()
            nf = launches.total("mbconv6", "forward") - f0
            nb = launches.total("mbconv6", "backward") - b0
            say(f"[cli] run {epochs}: {time.perf_counter() - t:.1f} s, step {state.step}, "
                f"e6 kernel calls fwd {nf} bwd {nb}")
            if state.step != STEPS * epochs:
                raise SmokeFailure(f"cli run {epochs}: step {state.step}, expected "
                                   f"{STEPS * epochs}")
            if (nf, nb) != (14 * STEPS, 14 * STEPS):
                raise SmokeFailure(f"cli run {epochs}: expected 14 forward and 14 backward "
                                   f"e6 calls per train step, got {nf} and {nb} in {STEPS}")
        counts = dict(launches.counts)
        del state
        span, busy, top = step_trace_summary(workdir / "profile" / "trace_step1.json")
        say(f"[cli trace] step 2 of run 1 (profiled): kernels from first to last {span / 1e3:.1f} "
            f"ms, kernel time {busy / 1e3:.1f} ms, device busy share {busy / span:.3f}; top: "
            + ", ".join(f"{short_name(k)} x{n} {t / 1e3:.1f} ms" for k, (n, t) in top[:10]))

        cfg = json.loads((workdir / "config.json").read_text())
        ref = bench_recipe_config(compat=True).to_dict()
        for key in ("model", "loss", "optimizer", "augment"):
            if cfg[key] != ref[key]:
                raise SmokeFailure(f"cli config.{key} is not the compat recipe's")
        for step in (STEPS, 2 * STEPS):
            d = workdir / "checkpoints" / str(step)
            missing = [f for f in ("meta.json", "config.json", "state.pt") if not (d / f).exists()]
            if missing:
                raise SmokeFailure(f"checkpoint {d} lacks {missing}")
        best = [d.name for d in (workdir / "best").iterdir()] if (workdir / "best").is_dir() else []
        if not best:
            raise SmokeFailure("cli wrote no best/ checkpoint")
        rows = [json.loads(line) for line in (workdir / "metrics.jsonl").read_text().splitlines()]
        train = [r for r in rows if r["prefix"] == "train"]
        valid = [r for r in rows if r["prefix"] == "valid"]
        if [r["step"] for r in train] != list(range(1, 2 * STEPS + 1)) or len(valid) != 2:
            raise SmokeFailure(f"metrics: train steps {[r['step'] for r in train]}, "
                               f"{len(valid)} validation rows")
        if not all(math.isfinite(r["loss/total"]) for r in train + valid):
            raise SmokeFailure("cli: a loss is not finite")
        step_ms = [1e3 * BATCH / r["perf/images_per_sec"] for r in train]
        left = [t.name for t in threading.enumerate() if t is not threading.main_thread()
                and (not t.daemon or t.name == "prefetch_to_device")]
        if left:
            raise SmokeFailure(f"threads left behind: {left}")
        say(f"[cli] losses {[round(r['loss/total'], 6) for r in train]}, validation "
            f"{[round(r['loss/total'], 6) for r in valid]}, best/ at step {best}")
        say(f"[cli] per-step ms (host clock, data wait included) "
            f"{[round(m, 1) for m in step_ms]}")
        say(f"[cli] checkpoint write s {[round(t, 2) for t in seconds['write']]}, "
            f"read s {[round(t, 2) for t in seconds['read']]}, no thread left behind")
        return dict(counts=counts, step_ms=step_ms, write_s=seconds["write"],
                    read_s=seconds["read"], losses=[r["loss/total"] for r in train]), tmp
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    finally:
        trainer_mod.save_checkpoint, trainer_mod.restore_checkpoint = save0, restore0



# --------------------------------------------------------------------------
# phase 10: serving (the evaluation entry points)
# --------------------------------------------------------------------------

SERVE_ROWS = 32
SERVE_BATCH = 16
SERVE_TIMED_BATCHES = 4
REF_EMBED_TOL = 1e-3


def write_zeroshot_csv(path, n):
    """n VinDr-style rows with both classes of Mass and Suspicious_Calcification."""
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["patient_id", "image_id", "Mass", "Suspicious_Calcification"])
        for i in range(n):
            w.writerow([f"s{i}", f"v{i}.png", i % 2, (i // 2) % 2])
    return path


def write_retrieval_csv(path, n, n_texts):
    """n rows whose reports repeat every ``n_texts`` rows."""
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["patient_id", "image", "text"])
        for i in range(n):
            w.writerow([f"r{i}", str([f"r{i}a.png", f"r{i}b.png"]),
                        str([f"finding {i % n_texts}.", "no interval change."])])
    return path


def host_timed(fn):
    """Host seconds of ``fn()``, which ends in a copy to the host, bracketed by
    ``torch.cuda.synchronize()``."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def card_vs_cpu(path):
    """Load ``path`` with ``load_clip_for_eval`` on the card and on the CPU and
    embed the same 2 images (a synthetic one and a ramp) and 2 texts on both.
    Returns (numbers, the card's model, its config)."""
    import numpy as np

    from mammo_clip_tpu_torch.data.images import SyntheticImageStore
    from mammo_clip_tpu_torch.data.tokenizer import load_tokenizer
    from mammo_clip_tpu_torch.eval.embeddings import EmbeddingExtractor
    from mammo_clip_tpu_torch.eval.loading import load_clip_for_eval

    texts = ["there is a mass in the left breast.", "no suspicious calcification."]
    embs, loads, kept = {}, {}, None
    for device in ("cuda", "cpu"):
        t = time.perf_counter()
        model, cfg = load_clip_for_eval(path, device=device)
        loads[device] = time.perf_counter() - t
        h, w = cfg.data.image_size_h, cfg.data.image_size_w
        ramp = np.broadcast_to(np.linspace(0, 255, w).astype(np.uint8), (h, w))
        images = np.stack([SyntheticImageStore((h, w)).get("d0", "a.png"), ramp])[..., None]
        ex = EmbeddingExtractor(model, cfg.data.mean, cfg.data.std, batch_size=2)
        tok = load_tokenizer({"vocab_size": cfg.model.text_encoder.vocab_size,
                              "name": cfg.model.text_encoder.name})
        enc = tok(texts, max_length=cfg.data.text_max_length)
        embs[device] = (ex.encode_images(images),
                        ex.encode_texts(enc["input_ids"], enc["attention_mask"]))
        if device == "cuda":
            kept = (model, cfg)
        del model, ex
    (img_c, txt_c), (img_h, txt_h) = embs["cuda"], embs["cpu"]
    res = dict(err_images=float(np.abs(img_c - img_h).max()),
               err_texts=float(np.abs(txt_c - txt_h).max()),
               spread_images=float(np.abs(img_c[0] - img_c[1]).max()),
               spread_texts=float(np.abs(txt_c[0] - txt_c[1]).max()),
               load_cuda_s=loads["cuda"], load_cpu_s=loads["cpu"])
    return (res,) + kept


def serving_phase(seed, workdir):
    """Phase 10: cli/zeroshot, cli/retrieval and cli/validate on phase 7's run
    (``workdir``), a fake reference .tar at the full B5 shapes through
    cli/zeroshot and load_clip_for_eval on the card and on the CPU, then the
    extractor's images/s and texts/s; the fused MBConv counters must read 0."""
    import tempfile

    import numpy as np
    import torch

    from mammo_clip_tpu_torch.cli import retrieval, validate, zeroshot
    from mammo_clip_tpu_torch.eval.embeddings import EmbeddingExtractor
    from mammo_clip_tpu_torch.ops.mbconv import launches
    from mammo_clip_tpu_torch.parity.fake_checkpoint import make_fake_public_tar
    from mammo_clip_tpu_torch.train.checkpoint import all_steps

    card = card_line()
    say(f"[serve] phase 10 on {card}")
    t_phase = time.perf_counter()
    launches.reset()
    torch.cuda.reset_peak_memory_stats()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    out = {}
    try:
        best = str(workdir / "best")
        common = ["--image-dir", "synthetic://", "--batch-size", str(SERVE_BATCH),
                  "--device", "cuda"]

        # (a) zero-shot on the pretraining run's best/
        zs_csv = str(write_zeroshot_csv(tmp / "zs.csv", SERVE_ROWS))
        t = time.perf_counter()
        zs = zeroshot.main(["--checkpoint", best, "--csv", zs_csv] + common)
        out["zeroshot"], out["zeroshot_s"] = zs, time.perf_counter() - t
        if set(zs) != {"mass", "suspicious_calcification"} or \
                not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in zs.values()):
            raise SmokeFailure(f"zero-shot on best/: {zs}")
        say(f"[serve] (a) cli/zeroshot on best/ ({SERVE_ROWS} rows): AUROC {zs}, "
            f"{out['zeroshot_s']:.1f} s")

        # (b) retrieval over rows whose reports repeat
        n_texts = SERVE_ROWS // 4
        ret_csv = str(write_retrieval_csv(tmp / "ret.csv", SERVE_ROWS, n_texts))
        t = time.perf_counter()
        ret = retrieval.main(["--checkpoint", best, "--csv", ret_csv] + common)["retrieval_i2t"]
        out["retrieval"], out["retrieval_s"] = ret, time.perf_counter() - t
        recalls = [ret[f"Recall@{k}"] for k in (1, 5, 10, 15)]
        if not (all(0.0 <= r <= 1.0 for r in recalls)
                and all(a <= b for a, b in zip(recalls, recalls[1:]))
                and 1.0 <= ret["MeanRank"] <= n_texts):
            raise SmokeFailure(f"retrieval on best/: {ret} ({n_texts} unique texts)")
        say(f"[serve] (b) cli/retrieval on best/ ({SERVE_ROWS} rows, {n_texts} unique texts): "
            f"{ret}, {out['retrieval_s']:.1f} s")

        # (c) validate every checkpointed step of the run
        t = time.perf_counter()
        summary = validate.main(["--workdir", str(workdir), "--device", "cuda"])
        out["validate_s"] = time.perf_counter() - t
        losses = summary["losses"]
        steps = all_steps(str(workdir / "checkpoints"))
        if sorted(losses) != steps or not all(math.isfinite(v) for v in losses.values()) \
                or summary["best_step"] != min(losses, key=losses.get):
            raise SmokeFailure(f"validate: {summary}, checkpointed steps {steps}")
        logged = {r["step"]: r["loss/contrastive"] for r in map(
            json.loads, (workdir / "metrics.jsonl").read_text().splitlines())
            if r["prefix"] == "valid"}
        out["validate"] = {"losses": losses, "best_step": summary["best_step"],
                           "trainer_logged": {s_: logged.get(s_) for s_ in steps}}
        say(f"[serve] (c) cli/validate: contrastive {losses}, best step "
            f"{summary['best_step']}, {out['validate_s']:.1f} s; the trainer's logged "
            f"validation loss at those steps (bf16 activations, validate's fp32: printed, "
            f"not gated): {out['validate']['trainer_logged']}")

        # (d) the reference-format route at the full B5 shapes
        t = time.perf_counter()
        tar = make_fake_public_tar(str(tmp / "b5-model-best-epoch-7.tar"), variant="b5",
                                   image_hw=(1520, 912), text_max_length=256, seed=seed)
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        zs_ref = zeroshot.main(["--checkpoint", tar, "--csv", zs_csv] + common)
        out["reference_zeroshot"], out["reference_zeroshot_s"] = zs_ref, time.perf_counter() - t
        if not all(math.isfinite(v) for v in zs_ref.values()):
            raise SmokeFailure(f"zero-shot on the reference-format .tar: {zs_ref}")
        n_params, serve_model, serve_cfg = None, None, None
        for name, path in (("reference .tar", tar), ("best/", best)):
            res, model, cfg = card_vs_cpu(path)
            out["reference" if path == tar else "best_card_vs_cpu"] = res
            if path == tar:
                n_params = sum(p.numel() for p in model.parameters())
                serve_model, serve_cfg = model, cfg
                say(f"[serve] (d) fake reference .tar at B5 ({n_params} params, "
                    f"{cfg.data.image_size_h}x{cfg.data.image_size_w}, "
                    f"{cfg.data.text_max_length} tokens; written in {write_s:.1f} s): "
                    f"cli/zeroshot {zs_ref} in {out['reference_zeroshot_s']:.1f} s")
            del model
            say(f"[serve] (d) {name}: load_clip_for_eval {res['load_cuda_s']:.1f} s (cuda), "
                f"{res['load_cpu_s']:.1f} s (cpu); unit-norm embeddings card vs CPU max|diff| "
                f"images {res['err_images']:.2e}, texts {res['err_texts']:.2e} (tol "
                f"{REF_EMBED_TOL:g}, TF32 off); between the two inputs on the card: images "
                f"{res['spread_images']:.2e}, texts {res['spread_texts']:.2e}")
            if not (res["err_images"] <= REF_EMBED_TOL and res["err_texts"] <= REF_EMBED_TOL):
                raise SmokeFailure(f"{name}: card vs CPU embeddings differ by "
                                   f"{res['err_images']:.2e} / {res['err_texts']:.2e} "
                                   f"(tol {REF_EMBED_TOL:g})")
        out["reference"]["params"] = n_params

        # (e) the extractor's throughput at batch 16, fp32
        ex = EmbeddingExtractor(serve_model, serve_cfg.data.mean, serve_cfg.data.std,
                                batch_size=SERVE_BATCH)
        rng = np.random.default_rng(seed)
        n = SERVE_BATCH * SERVE_TIMED_BATCHES
        h, w = serve_cfg.data.image_size_h, serve_cfg.data.image_size_w
        imgs = rng.integers(0, 256, (SERVE_BATCH + n, h, w, 1), dtype=np.uint8)
        s_len = serve_cfg.data.text_max_length
        ids = rng.integers(4, serve_cfg.model.text_encoder.vocab_size,
                           (SERVE_BATCH + n, s_len)).astype(np.int32)
        mask = np.ones_like(ids)
        phase_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ex.encode_images(imgs[:SERVE_BATCH])  # warm-up batch
        img_s = host_timed(lambda: ex.encode_images(imgs[SERVE_BATCH:]))
        ex.encode_texts(ids[:SERVE_BATCH], mask[:SERVE_BATCH])
        txt_s = host_timed(lambda: ex.encode_texts(ids[SERVE_BATCH:], mask[SERVE_BATCH:]))
        serve_peak = torch.cuda.max_memory_allocated()
        phase_peak = max(phase_peak, serve_peak)
        out["throughput"] = dict(images_per_s=n / img_s, texts_per_s=n / txt_s,
                                 image_batch_ms=1e3 * img_s / SERVE_TIMED_BATCHES,
                                 text_batch_ms=1e3 * txt_s / SERVE_TIMED_BATCHES,
                                 peak_bytes=serve_peak, phase_peak_bytes=phase_peak, card=card)
        del serve_model, ex
        counts = dict(launches.counts)
        out["fused_counts"] = counts
        out["seconds"] = time.perf_counter() - t_phase
        say(f"[serve] (e) {card}: encode_images {n / img_s:.2f} images/s "
            f"({1e3 * img_s / SERVE_TIMED_BATCHES:.1f} ms a batch of {SERVE_BATCH} at {h}x{w}, "
            f"fp32, {SERVE_TIMED_BATCHES} batches after 1 warm-up, host clock); encode_texts "
            f"{n / txt_s:.1f} texts/s ({1e3 * txt_s / SERVE_TIMED_BATCHES:.1f} ms a batch of "
            f"{SERVE_BATCH} x {s_len} tokens); peak memory {serve_peak} B "
            f"({serve_peak / 2**30:.2f} GiB) in (e), {phase_peak} B "
            f"({phase_peak / 2**30:.2f} GiB) in the phase; phase {out['seconds']:.1f} s")
        say(f"[serve] fused MBConv launch counters over (a)-(e): {counts}")
        if any(counts.values()):
            raise SmokeFailure(f"serving launched a fused MBConv kernel: {counts} (eval takes "
                               "the unfused blocks)")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 11: the downstream classifier
# --------------------------------------------------------------------------

CLF_BATCH = 8
CLF_TRAIN_ROWS = 32
CLF_VALID_ROWS = 20
# validation fold: patient ids of unequal length (the RSNA aggregation sorts
# them as the strings they are), laterality L for rows 0-7 and 16-19, R for
# 8-15: 16 (patient, laterality) groups, both classes
CLF_PATIENTS = ["3", "17", "250", "41", "5", "1999", "60", "8"]


def write_classifier_csv(path):
    """CLF_TRAIN_ROWS training rows (folds 1-3) and CLF_VALID_ROWS validation
    rows (fold 0); returns the count of validation (patient, laterality) groups."""
    import csv

    valid = [(CLF_PATIENTS[j % 8], "LR"[(j // 8) % 2], (j % 8) % 2)
             for j in range(CLF_VALID_ROWS)]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["patient_id", "image_id", "laterality", "cancer", "fold"])
        for i in range(CLF_TRAIN_ROWS):
            w.writerow([f"t{i}", f"t{i}.png", "LR"[i % 2], i % 2, 1 + i % 3])
        for j, (p, lat, c) in enumerate(valid):
            w.writerow([p, f"v{j}.png", lat, c, 0])
    return len({(p, lat) for p, lat, _ in valid})


def classifier_kernel_cases(seed):
    """(a): the fused block at the ft arm's shapes, N=8, fp32: each form against
    its plain version (out, stats, dx, every gradient), its times beside the
    plain version's and the bound, and its held bytes. Returns kernel rows."""
    import torch

    rows = []
    for case in (Case("block4_e6_n8_fp32", "e6", CLF_BATCH, 40, 40, 380, 228, seed + 20),
                 Case("block0_e1_n8_fp32", "e1", CLF_BATCH, 48, 24, 760, 456, seed + 21),
                 Case("block1_e1_n8_fp32", "e1", CLF_BATCH, 24, 24, 760, 456, seed + 22)):
        err = check_case(case, "float32")
        k_fwd, k_bwd, p_fwd, p_bwd = time_case(case, "float32", reps=5)
        from mammo_clip_tpu_torch.ops.mbconv6 import fused_mbconv_e6

        allocated, requested = held_bytes(fused_mbconv_e6, case, "float32")
        say(f"[clf kernel] {case.name}: held from forward to backward beyond x and the "
            f"outputs: {requested} B requested ({allocated} B allocated)")
        for direction, ms, plain in (("forward", k_fwd, p_fwd), ("backward", k_bwd, p_bwd)):
            bound_ms, bound_by, which = case.bound(direction, "float32")
            say(f"[clf kernel] {case.name} {direction} fp32 N={case.N} {case.H}x{case.W}: "
                f"kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {bound_ms:.4f} ms ({which})")
            rows.append(dict(case=case.name, form=case.form, direction=direction, err=err,
                             ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by=bound_by,
                             held_requested=requested))
        del case
        torch.cuda.empty_cache()
    return rows


def classifier_reference_check(seed):
    """(b): one ft step of a tiny classifier (b0 at 64x48, fused route on, 2
    images) on the card with the kernel against the same step on the CPU with
    the plain version, from the same weights: loss and head gradient."""
    import torch

    from mammo_clip_tpu_torch.downstream.classify import MammoClassifier
    from mammo_clip_tpu_torch.losses.classification import bce_with_logits_loss
    from mammo_clip_tpu_torch.models import init_parameters
    from mammo_clip_tpu_torch.ops.mbconv import launches

    enc = {"name": "efficientnet-b0", "fused_mbconv": True, "drop_connect_rate": 0.0}
    cpu = MammoClassifier(enc)
    init_parameters(cpu, torch.Generator().manual_seed(seed))
    images = torch.randn(2, 64, 48, 1, generator=torch.Generator().manual_seed(seed + 1))
    labels = torch.tensor([0.0, 1.0])
    results = []
    for device in ("cuda", "cpu"):
        model = MammoClassifier(enc).to(device)
        model.load_state_dict(cpu.state_dict())
        f0 = launches.total("mbconv6", "forward")
        loss = bce_with_logits_loss(model(images.to(device), train=True)["logits"][:, 0],
                                    labels.to(device))
        loss.backward()
        results.append((loss.item(), model.head.kernel.grad.cpu(),
                        launches.total("mbconv6", "forward") - f0))
    (lk, gk, nk), (lc, gc, nc) = results
    err_l, err_g = abs(lk - lc), float((gk - gc).abs().max())
    say(f"[clf reference] tiny classifier ft step, kernels (card) vs plain (CPU): loss "
        f"{lk:.6f} vs {lc:.6f} (|diff| {err_l:.2e}, tol 1e-3), head gradient max|diff| "
        f"{err_g:.2e} (tol 1e-3), kernel forward calls {nk} (card) / {nc} (CPU)")
    if not (err_l <= 1e-3 and err_g <= 1e-3 and nk > 0 and nc == 0):
        raise SmokeFailure("tiny classifier ft step on the card disagrees with the CPU")


def classifier_phase(seed, workdir):
    """Phase 11 on phase 7's run (``workdir``): (a) the kernel at N=8 fp32,
    (b) a tiny ft step on the card against the CPU, (c) cli/classifier lp and ft
    on ``best/`` (1 epoch, then --resume to 2) with the fused counters read per
    train and validation step, (d) cli/rescore on each best/, (e) numbers."""
    import contextlib
    import io
    import tempfile

    import torch

    from mammo_clip_tpu_torch.cli import classifier, rescore
    from mammo_clip_tpu_torch.downstream import experiments
    from mammo_clip_tpu_torch.ops.mbconv import launches
    from mammo_clip_tpu_torch.train.checkpoint import load_checkpoint_arrays

    card = card_line()
    say(f"[clf] phase 11 on {card}")
    t_phase = time.perf_counter()
    out = {"kernels": classifier_kernel_cases(seed)}
    classifier_reference_check(seed)

    # instrument the training loop: per-step host ms (ending in a synchronise) and the
    # fused counters around every train and validation step; checkpoint writes
    steps = []
    make0, save0 = experiments.make_classifier_steps, experiments.save_checkpoint

    def counted(kind, fn):
        def wrapped(*a, **k):
            f0, b0 = launches.total("mbconv6", "forward"), launches.total("mbconv6", "backward")
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            steps.append(dict(kind=kind, ms=(time.perf_counter() - t) * 1e3,
                              fwd=launches.total("mbconv6", "forward") - f0,
                              bwd=launches.total("mbconv6", "backward") - b0,
                              tf32=torch.backends.cuda.matmul.allow_tf32
                              or torch.backends.cudnn.allow_tf32))
            return res
        return wrapped

    def instrumented(*a, **k):
        train_step, eval_step = make0(*a, **k)
        return counted("train", train_step), counted("valid", eval_step)

    writes = []

    def timed_save(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        save0(*a, **k)
        writes.append(time.perf_counter() - t)

    experiments.make_classifier_steps, experiments.save_checkpoint = instrumented, timed_save
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_clf_"))
    try:
        n_groups = write_classifier_csv(tmp / "rsna.csv")
        best = str(workdir / "best")
        out["arms"] = {}
        launches.reset()
        # torch's default, which a user's process has: the CLI must run its steps in full fp32
        torch.backends.cudnn.allow_tf32 = True
        for arch in ("lp", "ft"):
            torch.cuda.reset_peak_memory_stats()
            arm = out["arms"][arch] = {"runs": []}
            work = tmp / arch
            flags = ["--clip-checkpoint", best, "--csv", str(tmp / "rsna.csv"),
                     "--image-dir", "synthetic://", "--arch", arch,
                     "--batch-size", str(CLF_BATCH), "--weighted-bce", "--device", "cuda",
                     "--workdir", str(work)]
            for extra in (["--epochs", "1"], ["--epochs", "2", "--resume"]):
                del steps[:]
                buf = io.StringIO()
                t = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    res = classifier.main(flags + extra)
                seconds = time.perf_counter() - t
                lines = buf.getvalue().strip().splitlines()
                train = [s_ for s_ in steps if s_["kind"] == "train"]
                valid = [s_ for s_ in steps if s_["kind"] == "valid"]
                run = dict(argv=extra, result=res, seconds=seconds, train=train, valid=valid,
                           writes=list(writes))
                del writes[:]
                arm["runs"].append(run)
                resumed = "--resume" in extra
                say(f"[clf] {arch} {' '.join(extra)}: {seconds:.1f} s, best_metric "
                    f"{res['best_metric']:.6f}, history {res['history']}, train steps "
                    f"{len(train)}, validation batches {len(valid)}, train ms "
                    f"{[round(s_['ms'], 1) for s_ in train]}, checkpoint write s "
                    f"{[round(w_, 2) for w_ in run['writes']]}")
                if json.loads(lines[-1]) != res:
                    raise SmokeFailure(f"{arch}: the CLI's JSON line is not its result")
                if not (math.isfinite(res["best_metric"]) and 0.0 <= res["best_metric"] <= 1.0):
                    raise SmokeFailure(f"{arch}: best_metric {res['best_metric']}")
                want_valid = -(-CLF_VALID_ROWS // CLF_BATCH)
                if len(train) != CLF_TRAIN_ROWS // CLF_BATCH or len(valid) != want_valid:
                    raise SmokeFailure(f"{arch} {extra}: {len(train)} train steps and "
                                       f"{len(valid)} validation batches, expected "
                                       f"{CLF_TRAIN_ROWS // CLF_BATCH} and {want_valid}")
                started = any(ln.startswith("resumed classifier at epoch 1") for ln in lines)
                if resumed and not (started and len(res["history"]) == 2):
                    raise SmokeFailure(f"{arch}: the resumed run did not start at epoch 1 "
                                       f"and end with a history of 2: {lines[:2]}, {res}")
                per_step = (7, 7) if arch == "ft" else (0, 0)
                bad = [s_ for s_ in train if (s_["fwd"], s_["bwd"]) != per_step]
                bad += [s_ for s_ in valid if (s_["fwd"], s_["bwd"]) != (0, 0)]
                if bad:
                    raise SmokeFailure(f"{arch}: fused launches per step {per_step} in train "
                                       f"and 0 in validation expected, got {bad}")
                if any(s_["tf32"] for s_ in steps):
                    raise SmokeFailure(f"{arch}: a step ran with TF32 on; the CLI runs fp32")
            arm["peak_bytes"] = torch.cuda.max_memory_allocated()
            arrays = load_checkpoint_arrays(str(work / "best"))
            if arrays["predictions"].shape != (n_groups,) or arrays["labels"].shape != (n_groups,):
                raise SmokeFailure(f"{arch}: best/ arrays {arrays['predictions'].shape}, "
                                   f"expected one prediction per group ({n_groups})")
            with contextlib.redirect_stdout(io.StringIO()):
                scores = rescore.main(["--checkpoint", str(work / "best")])
            arm["rescore"] = scores
            best_metric = arm["runs"][-1]["result"]["best_metric"]
            say(f"[clf] (d) {arch} cli/rescore on best/: {scores}; |auroc - best_metric| "
                f"{abs(scores['auroc'] - best_metric):.2e} (tol 1e-9)")
            if not abs(scores["auroc"] - best_metric) <= 1e-9:
                raise SmokeFailure(f"{arch}: rescore auroc {scores['auroc']} != best_metric "
                                   f"{best_metric}")
            timed = [s_["ms"] for r in arm["runs"] for s_ in r["train"][1:]]
            arm["step_ms"] = timed
            arm["images_per_s"] = [1e3 * CLF_BATCH / m for m in timed]
            arm["valid_ms"] = [s_["ms"] for r in arm["runs"] for s_ in r["valid"]]
            say(f"[clf] (e) {card}: {arch} at batch {CLF_BATCH}, 1520x912 fp32: train step ms "
                f"after step 0 of each run {[round(m, 1) for m in timed]} "
                f"({1e3 * CLF_BATCH * len(timed) / sum(timed):.2f} images/s), validation "
                f"batch ms {[round(m, 1) for m in arm['valid_ms']]}, peak memory "
                f"{arm['peak_bytes']} B ({arm['peak_bytes'] / 2**30:.2f} GiB), checkpoint "
                f"write s {[round(w_, 2) for r in arm['runs'] for w_ in r['writes']]}")
        out["fused_counts"] = dict(launches.counts)
        out["seconds"] = time.perf_counter() - t_phase
        say(f"[clf] fused MBConv launch counters over (c): {out['fused_counts']}; phase "
            f"{out['seconds']:.1f} s")
        return out
    finally:
        experiments.make_classifier_steps, experiments.save_checkpoint = make0, save0
        torch.backends.cudnn.allow_tf32 = False
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 12: detection (cli/detector on phase 7's best/)
# --------------------------------------------------------------------------

DET_SIZE = 512
DET_BATCH = 7
DET_TRAIN_IMAGES = 21  # 3 steps a run
DET_VALID_IMAGES = 9  # 7 + 2: the last validation batch is padded (R8)
DET_CLASSES = ["Mass", "Suspicious Calcification", "Focal Asymmetry", "Architectural Distortion"]


def write_detection_csv(path):
    """A VinDr-style box CSV of ``synthetic://`` images at DET_SIZE: one box row
    per finding, a second box on every third image, classes from DET_CLASSES."""
    import csv
    import random

    rnd = random.Random(0)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["study_id", "image_id", "finding_categories", "resized_xmin",
                    "resized_ymin", "resized_xmax", "resized_ymax", "split"])
        for i in range(DET_TRAIN_IMAGES + DET_VALID_IMAGES):
            split = "training" if i < DET_TRAIN_IMAGES else "test"
            for j in range(1 + (i % 3 == 0)):
                x0, y0 = rnd.uniform(10, 380), rnd.uniform(10, 380)
                bw, bh = rnd.uniform(24, 120), rnd.uniform(24, 120)
                w.writerow([f"s{i}", f"d{i}.png", str([DET_CLASSES[(i + j) % 4]]), round(x0, 1),
                            round(y0, 1), round(x0 + bw, 1), round(y0 + bh, 1), split])


def tiny_detector(seed, dtype_name="float32"):
    """A RetinaNet over b0 (fused route on, as the compat encoder), 3 classes,
    weights drawn from ``seed`` on the CPU."""
    import torch

    from mammo_clip_tpu_torch.models import init_parameters
    from mammo_clip_tpu_torch.models.retinanet import RetinaNet, init_heads

    enc = {"name": "efficientnet-b0", "fused_mbconv": True, "drop_connect_rate": 0.0}
    model = RetinaNet(enc, 3, dtype=getattr(torch, dtype_name))
    init_parameters(model, torch.Generator().manual_seed(seed))
    init_heads(model, torch.Generator().manual_seed(seed + 1))
    return model


def detector_reference_check(seed):
    """(a): a tiny RetinaNet (b0 at 64x64, 3 classes) on the card against the
    CPU from the same weights, fp32 with TF32 off: class probabilities and
    deltas (and, printed beside them, the card's bf16 forward against the
    CPU's fp32); one ``make_detector_steps`` train step with augmentation off:
    the focal loss's parts and the class head's gradient; ``detect`` hard and
    soft on a seeded candidate pool of distinct scores: the same valid slots,
    classes and scores, boxes within 1e-4. Returns the errors."""
    import torch

    from mammo_clip_tpu_torch.downstream.experiments import make_detector_steps
    from mammo_clip_tpu_torch.models.retinanet import detect
    from mammo_clip_tpu_torch.ops.augment import minmax_standardize
    from mammo_clip_tpu_torch.ops.boxes import build_anchors
    from mammo_clip_tpu_torch.ops.mbconv import launches
    from mammo_clip_tpu_torch.train import build_optimizer, create_train_state

    rel = lambda a, b: float((a.float().cpu() - b).abs().max() / b.abs().max().clamp_min(1e-12))
    err = {}
    cpu = tiny_detector(seed)
    images = torch.randn(2, 64, 64, 1, generator=torch.Generator().manual_seed(seed + 2))
    with torch.no_grad():
        want = cpu(images)
        for dtype_name in ("float32", "bfloat16"):
            card = tiny_detector(seed, dtype_name).cuda()
            card.load_state_dict(cpu.state_dict())
            got = card(images.cuda())
            for k in ("class_probs", "box_deltas"):
                err[f"{k}.{dtype_name}"] = rel(got[k], want[k])
    anchors = build_anchors((64, 64))
    g = torch.Generator().manual_seed(seed + 3)
    imgs = torch.randint(0, 256, (2, 64, 64, 1), generator=g, dtype=torch.uint8)
    ann = -torch.ones(2, 16, 5)
    ann[0, 0] = torch.tensor([*anchors[40], 0])
    ann[0, 1] = torch.tensor([5.0, 7.0, 30.0, 20.0, 2])
    ann[1, 0] = torch.tensor([*anchors[600], 1])
    pre = lambda b, gen: {**b, "images": minmax_standardize(b["images"], 0.3, 0.25)}
    steps = []
    for device in ("cuda", "cpu"):
        model = tiny_detector(seed).to(device)
        model.load_state_dict(cpu.state_dict())
        state = create_train_state(model, build_optimizer(
            {"name": "adam", "lr": 1e-4, "grad_clip_norm": 0.1}, lambda s: 1e-4,
            model.named_parameters()))
        grads = []
        step = state.apply_gradients
        state.apply_gradients = lambda: (grads.append(
            model.class_subnet.out.kernel.grad.detach().cpu().clone()), step())[1]
        train_step, _, _ = make_detector_steps(model, anchors, pre)
        n0 = launches.total("mbconv6", "forward") + launches.total("mbconv6", "backward")
        state, ld = train_step(state, {"images": imgs.to(device), "annotations": ann.to(device)},
                               torch.Generator(device=device), seed=0)
        n = launches.total("mbconv6", "forward") + launches.total("mbconv6", "backward") - n0
        steps.append(({k: v.item() for k, v in ld.items()}, grads[0], n))
    (lk, gk, nk), (lc, gc, nc) = steps
    for k in lc:
        err[f"loss.{k}"] = abs(lk[k] - lc[k]) / max(1.0, abs(lc[k]))
    err["head_grad"] = rel(gk, gc)
    A = anchors.shape[0]
    pool = {"class_probs": torch.randperm(2 * A * 3, generator=g).float().reshape(2, A, 3)
            / (2 * A * 3), "box_deltas": 0.5 * torch.randn(2, A, 4, generator=g)}
    at = torch.from_numpy(anchors)
    same = True
    for mode in ("hard", "soft"):
        dk = detect({k: v.cuda() for k, v in pool.items()}, at.cuda(), (64, 64),
                    score_threshold=0.3, nms=mode)
        dc = detect(pool, at, (64, 64), score_threshold=0.3, nms=mode)
        same &= torch.equal(dk["valid"].cpu(), dc["valid"]) and bool(dc["valid"].any())
        same &= torch.equal(dk["classes"].cpu(), dc["classes"])
        err[f"detect.{mode}.scores"] = float((dk["scores"].cpu() - dc["scores"]).abs().max())
        err[f"detect.{mode}.boxes"] = float((dk["boxes"].cpu() - dc["boxes"]).abs().max())
    say(f"[det reference] tiny RetinaNet b0 64x64, card vs CPU (TF32 off): "
        + ", ".join(f"{k} {v:.2e}" for k, v in err.items())
        + f"; focal parts card {lk}, CPU {lc}; detect valid slots and classes equal: {same}; "
        f"fused launches in the step {nk} (card) / {nc} (CPU)")
    ok = (err["class_probs.float32"] < 1e-4 and err["box_deltas.float32"] < 1e-4
          and err["class_probs.bfloat16"] < 5e-2 and err["box_deltas.bfloat16"] < 5e-2
          and all(err[f"loss.{k}"] <= 1e-4 for k in lc) and lc["regression"] > 0
          and err["head_grad"] < 1e-3 and same and nk == nc == 0
          and all(err[f"detect.{m}.scores"] <= 1e-6 and err[f"detect.{m}.boxes"] <= 1e-4
                  for m in ("hard", "soft")))
    if not ok:
        raise SmokeFailure("tiny RetinaNet on the card disagrees with the CPU")
    return err


def detector_phase(seed, workdir):
    """Phase 12 on phase 7's run (``workdir``): (a) the tiny RetinaNet card vs
    CPU, (b) cli/detector on ``best/`` at full width (1 epoch, then --resume to
    2) with the fused counters read around every train and validation step,
    (c) --resume to 3 with multi-scale soft-NMS evaluation, (d) numbers."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from mammo_clip_tpu_torch.cli import detector
    from mammo_clip_tpu_torch.ops.mbconv import launches
    from mammo_clip_tpu_torch.train.checkpoint import load_checkpoint_arrays

    card = card_line()
    say(f"[det] phase 12 on {card}")
    t_phase = time.perf_counter()
    out = {"reference": detector_reference_check(seed)}

    # instrument the loop: host ms per step (ending in a synchronise), the fused
    # counters around every train and validation step, the NMS alone, the writes
    steps, writes = [], []
    make0, detect0, save0 = detector.make_detector_steps, detector.detect, detector.save_checkpoint

    def counted(kind, fn):
        def wrapped(*a, **k):
            n0 = launches.total("mbconv6", "forward") + launches.total("mbconv6", "backward")
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            rec = dict(kind=kind, ms=(time.perf_counter() - t) * 1e3,
                       fused=launches.total("mbconv6", "forward")
                       + launches.total("mbconv6", "backward") - n0)
            if kind == "train":
                rec["losses"] = {k_: v.item() for k_, v in res[1].items()}
            steps.append(rec)
            return res
        return wrapped

    def instrumented(*a, **k):
        train_step, infer_step, infer_multiscale = make0(*a, **k)
        return (counted("train", train_step), counted("valid", infer_step),
                counted("valid_multiscale", infer_multiscale))

    def timed_save(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        save0(*a, **k)
        writes.append(time.perf_counter() - t)

    detector.make_detector_steps = instrumented
    detector.detect = counted("nms", detect0)
    detector.save_checkpoint = timed_save
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_det_"))
    try:
        write_detection_csv(tmp / "det.csv")
        work = tmp / "det"
        flags = ["--clip-checkpoint", str(workdir / "best"), "--csv", str(tmp / "det.csv"),
                 "--image-dir", "synthetic://", "--resize", str(DET_SIZE),
                 "--batch-size", str(DET_BATCH), "--device", "cuda", "--workdir", str(work)]
        launches.reset()
        torch.cuda.reset_peak_memory_stats()
        out["runs"] = []
        n_train = DET_TRAIN_IMAGES // DET_BATCH
        n_valid = -(-DET_VALID_IMAGES // DET_BATCH)
        for extra in (["--epochs", "1"], ["--epochs", "2", "--resume"],
                      ["--epochs", "3", "--resume", "--eval-scales", "0.75,1.0,1.25",
                       "--soft-nms"]):
            del steps[:], writes[:]
            buf = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res = detector.main(flags + extra)
            seconds = time.perf_counter() - t
            lines = buf.getvalue().strip().splitlines()
            by = {k: [s_ for s_ in steps if s_["kind"] == k]
                  for k in ("train", "valid", "valid_multiscale", "nms")}
            run = dict(argv=extra, result=res, seconds=seconds, writes=list(writes), **by)
            out["runs"].append(run)
            multiscale = "--eval-scales" in extra
            valid = by["valid_multiscale"] if multiscale else by["valid"]
            say(f"[det] {' '.join(extra)}: {seconds:.1f} s, best_mAP {res['best_mAP']:.6f}, "
                f"losses {[round(s_['losses']['total'], 5) for s_ in by['train']]}, train ms "
                f"{[round(s_['ms'], 1) for s_ in by['train']]}, validation batch ms "
                f"{[round(s_['ms'], 1) for s_ in valid]}, NMS ms "
                f"{[round(s_['ms'], 2) for s_ in by['nms']]}, checkpoint write s "
                f"{[round(w_, 2) for w_ in writes]}")
            if json.loads(lines[-1]) != res:
                raise SmokeFailure("cli/detector: the JSON line is not its result")
            if not (math.isfinite(res["best_mAP"]) and 0.0 <= res["best_mAP"] <= 1.0):
                raise SmokeFailure(f"cli/detector: best_mAP {res['best_mAP']}")
            if not all(math.isfinite(v) for s_ in by["train"] for v in s_["losses"].values()):
                raise SmokeFailure("cli/detector: a loss is not finite")
            if len(by["train"]) != n_train or len(valid) != n_valid:
                raise SmokeFailure(f"cli/detector {extra}: {len(by['train'])} train steps and "
                                   f"{len(valid)} validation batches, expected {n_train} and "
                                   f"{n_valid}")
            if len(by["nms"]) != (0 if multiscale else n_valid):
                raise SmokeFailure(f"cli/detector {extra}: {len(by['nms'])} NMS calls")
            if "--resume" in extra:
                epoch = int(extra[1]) - 1
                if not lines[0].startswith(f"resumed detector at epoch {epoch}"):
                    raise SmokeFailure(f"the resumed run did not start at epoch {epoch}: "
                                       f"{lines[:1]}")
            if any(s_["fused"] for s_ in steps):
                raise SmokeFailure(f"fused MBConv launches on the detection path: "
                                   f"{[s_ for s_ in steps if s_['fused']]}")
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        arrays = load_checkpoint_arrays(str(work / "best"))
        n_slots = 11 * 100
        if (arrays["scores"].shape != (DET_VALID_IMAGES, n_slots)
                or arrays["annotations"].shape[0] != DET_VALID_IMAGES):
            raise SmokeFailure(f"best/ arrays {arrays['scores'].shape}, expected one slate per "
                               f"validation image ({DET_VALID_IMAGES}, {n_slots})")
        if not (arrays["scores"][~arrays["valid"]] == 0).all():
            raise SmokeFailure("best/ arrays: an invalid slot with a score")
        runs = out["runs"]
        out["step_ms"] = [s_["ms"] for r in runs for s_ in r["train"][1:]]
        out["images_per_s"] = 1e3 * DET_BATCH * len(out["step_ms"]) / sum(out["step_ms"])
        out["valid_ms"] = [s_["ms"] for r in runs[:2] for s_ in r["valid"]]
        out["multiscale_ms"] = [s_["ms"] for s_ in runs[2]["valid_multiscale"]]
        out["nms_ms"] = [s_["ms"] for r in runs for s_ in r["nms"]]
        out["write_s"] = [w_ for r in runs for w_ in r["writes"]]
        out["fused_counts"] = dict(launches.counts)
        out["seconds"] = time.perf_counter() - t_phase
        say(f"[det] (d) {card}: cli/detector B5 at {DET_SIZE}x{DET_SIZE}, batch {DET_BATCH}, "
            f"bf16: train step ms after step 0 of each run "
            f"{[round(m, 1) for m in out['step_ms']]} ({out['images_per_s']:.2f} images/s), "
            f"validation batch ms (forward + NMS) {[round(m, 1) for m in out['valid_ms']]}, "
            f"of it NMS (decode, clip, per-class NMS over 11 classes) ms "
            f"{[round(m, 2) for m in out['nms_ms']]}, multi-scale soft-NMS validation batch ms "
            f"{[round(m, 1) for m in out['multiscale_ms']]}, peak memory {out['peak_bytes']} B "
            f"({out['peak_bytes'] / 2**30:.2f} GiB), checkpoint write s "
            f"{[round(w_, 2) for w_ in out['write_s']]}, best/ slates "
            f"{arrays['scores'].shape[0]}, fused MBConv launches {out['fused_counts']}, phase "
            f"{out['seconds']:.1f} s")
        return out
    finally:
        detector.make_detector_steps, detector.detect = make0, detect0
        detector.save_checkpoint = save0
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 8: flash attention
# --------------------------------------------------------------------------


def bound(nbytes, ops):
    """(bound_ms, bound_by, which): the largest of bytes over the HBM rate and,
    for each unit, its operations over its peak rate (``ops``: name -> (flops,
    peak)). bound_by is "bytes" or "operations"; which names the part."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S, **{k: f / pk for k, (f, pk) in ops.items()}}
    which = max(times, key=times.get)
    return times[which] * 1e3, ("bytes" if which == "bytes" else "operations"), which


def flash_inputs(shape, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return [(s * torch.randn(*shape, generator=g, device="cuda")).to(dtype)
            for s in (0.3, 0.3, 0.3, 0.1)]


def flash_outputs(fn, inputs, scale):
    """out, dq, dk, dv of ``fn`` (fp32 copies) through its loss sum(out * g)."""
    import torch

    q0, k0, v0, g = inputs
    q, k, v = (t.clone().requires_grad_(True) for t in (q0, k0, v0))
    out = fn(q, k, v, scale)
    out.backward(g)
    torch.cuda.synchronize()
    return [out.detach().float(), q.grad.float(), k.grad.float(), v.grad.float()]


def check_flash(shape, dtype_name, seed, yardstick=False):
    """The kernel (through its wrapper) against the plain version: out, dq, dk,
    dv, each max |diff| relative to the largest entry beside its tolerance; with
    ``yardstick``, SDPA's own distance from the plain version beside it (what a
    library tensor-core attention gives at these inputs). Returns the max abs
    error of out and of the gradients."""
    import torch
    import torch.nn.functional as F

    from mammo_clip_tpu_torch.ops.flash_attention import flash_attention, plain_flash_attention

    inputs = flash_inputs(shape, getattr(torch, dtype_name), seed)
    scale = shape[-1] ** -0.5
    runs = [flash_outputs(fn, inputs, scale) for fn in (flash_attention, plain_flash_attention)]
    tol = 1e-2 if dtype_name == "bfloat16" else 1e-4
    rows = [(n, max_rel(a, b)) for n, a, b in zip(("out", "dq", "dk", "dv"), *runs)]
    say(f"[flash check] {shape} {dtype_name}: " + ", ".join(f"{n} {e:.2e}/{tol:.0e}"
                                                           for n, e in rows))
    if yardstick:
        sdpa = flash_outputs(lambda q, k, v, scale: F.scaled_dot_product_attention(
            q, k, v, scale=scale), inputs, scale)
        say(f"[flash check] {shape} {dtype_name}, SDPA against the plain version (yardstick, "
            "no bound): " + ", ".join(f"{n} {max_rel(a, b):.2e}" for n, a, b in
                                      zip(("out", "dq", "dk", "dv"), sdpa, runs[1])))
    if not all(e <= tol for _, e in rows):
        raise SmokeFailure(f"flash attention {shape} {dtype_name} disagrees with plain: {rows}")
    abs_err = [float((a - b).abs().max()) for a, b in zip(*runs)]
    return abs_err[0], max(abs_err[1:])


def flash_label(mangled):
    """'fwd_tc<64>', 'dkdv<float,128>', 'dot<bf16>', 'dot_v8' for a kernel of
    csrc/flash_attention.cu, from its mangled name; None for any other kernel."""
    m = re.search(r"\d(fwd_tc|dkdv_tc|dq_tc|dot_v8|fwd|dkdv|dq|dot)_kernel(I.*?EE)?", mangled)
    if not m:
        return None
    targs = m.group(2) or ""
    args = (["float"] if targs.startswith("If") else ["bf16"] if "bfloat16" in targs else [])
    args += re.findall(r"Li(\d+)E", targs)
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def library_report(lib_path, ptxas_log, label, sass_name):
    """The built library's kernels that ``label`` names: each one's registers,
    static shared memory, stack and local memory (``cuobjdump
    --dump-resource-usage``), its counts of HMMA (tensor-core) and atomic
    instructions in the SASS and its bulk-copy instructions (``UBLKCP``, as
    the SASS names them), and its spill stores (the build's ptxas log, when
    it compiled now). Their SASS goes to chiprun_out/``sass_name``."""
    from mammo_clip_tpu_torch.ops import cuda_lib

    tool = str(Path(cuda_lib._nvcc()).parent / "cuobjdump")

    def run(*args):
        res = subprocess.run([tool, *args, str(lib_path)], capture_output=True, text=True,
                             timeout=300)
        if res.returncode != 0:
            raise SmokeFailure(f"cuobjdump {' '.join(args)} failed: {res.stderr[-2000:]}")
        return res.stdout

    usage, name = {}, None
    for line in run("--dump-resource-usage").splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = label(m.group(1))
        elif name and "REG:" in line:
            usage[name] = dict(re.findall(r"([A-Z]+):(\d+)", line))
            name = None
    sass = run("-sass")
    (OUT_DIR / sass_name).write_text("\n".join(
        chunk for chunk in re.split(r"\n(?=\s*Function : )", sass)
        if label(chunk.split("\n", 1)[0])))
    counts = {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        lab = label(chunk.split("\n", 1)[0])
        if lab:
            counts[lab] = (len(re.findall(r"\bHMMA\.", chunk)),
                           len(re.findall(r"\b(?:ATOMS|ATOMG|ATOM|RED)\.", chunk)),
                           re.findall(r"\bU?BLKCP[.\w]*", chunk))
    spills = {label(n): b for n, b in re.findall(
        r"Function properties for (\S+)\n\s*\d+ bytes stack frame, (\d+) bytes spill stores",
        ptxas_log or "") if label(n)}
    return usage, counts, spills


def flash_kernel_report(lib_path, ptxas_log):
    """Phase 8's look into the built library: each flash kernel's registers,
    static shared memory, stack and local memory, spill stores, its dynamic
    shared memory per block (the tile layout of the source), and its count of
    HMMA (tensor-core) and atomic instructions in the SASS (``library_report``).
    Fails if a bf16 tensor-core kernel has no HMMA, or any flash kernel has an
    atomic."""
    usage, counts, spills = library_report(lib_path, ptxas_log, flash_label,
                                           "flash_attention.sass")
    tc = [k for k in counts if k.split("<")[0] in ("fwd_tc", "dkdv_tc", "dq_tc")]
    for label in sorted(counts):
        u = usage.get(label, {})
        dyn = ""
        if label in tc:  # fwd_tc_smem / bwd_tc_smem of the source
            dmax, fwd = int(label[label.index("<") + 1:-1]), label.startswith("fwd")
            smem = (5 if fwd else 6) * 64 * (dmax + 8) * 2 + (0 if fwd else 4 * 64 * 4)
            dyn = f", dynamic shared {smem} B"
        say(f"[flash kernels] {label}: REG {u.get('REG')}, SHARED {u.get('SHARED')}, STACK "
            f"{u.get('STACK')}, LOCAL {u.get('LOCAL')}{dyn}, spill stores "
            f"{spills.get(label, 'not read (built earlier)')} B, HMMA {counts[label][0]}, "
            f"atomics {counts[label][1]}")
    missing = [k for k in tc if counts[k][0] == 0]
    atomics = [k for k, c in counts.items() if c[1]]
    if len(tc) != 9 or missing or atomics:
        raise SmokeFailure(f"flash SASS: tensor-core kernels {tc}, without HMMA {missing}, "
                           f"with atomics {atomics}")


def flash_phases(seed, earlier=None):
    """Phase 8. Returns the forward and backward rows of the kernels line; with
    ``earlier`` (parent_turns'), their earlier_host_us."""
    import torch
    import torch.nn.functional as F

    from mammo_clip_tpu_torch.benchmarks import layout_timing
    from mammo_clip_tpu_torch.benchmarks import probe_flash_attention as probe
    from mammo_clip_tpu_torch.benchmarks.layout_timing import device_ms
    from mammo_clip_tpu_torch.models.bert import attention
    from mammo_clip_tpu_torch.ops import cuda_lib
    from mammo_clip_tpu_torch.ops import flash_attention as flash_module
    from mammo_clip_tpu_torch.ops.flash_attention import (
        flash_backward,
        flash_forward,
        launches,
        plain_flash_attention,
    )

    shape = (probe.B, probe.N, probe.S, probe.D)
    flash_kernel_report(cuda_lib.build_info.path, cuda_lib.build_info.ptxas)
    errs = {}
    for name, shp in (("probe", shape), ("ragged", (4, 12, 200, 32))):
        for dt in ("float32", "bfloat16"):
            errs[name, dt] = check_flash(shp, dt, seed, yardstick=dt == "bfloat16")

    launches.reset()
    res = probe.main(["--iters", "10"])
    counts = dict(launches.counts)
    say(f"[flash path] probe_flash_attention (einsum, flash, sdpa): counters {counts}, "
        f"loss rel diff einsum vs flash {res['rel']:.2e} (tol 1e-2)")
    if not (res["rel"] < 1e-2 and all(math.isfinite(v) for v in res["loss"].values())):
        raise SmokeFailure(f"flash probe numerics: {res}")
    if min(counts.values()) < 1:
        raise SmokeFailure(f"flash path launched no kernel in one direction: {counts}")

    q, k, v, g = flash_inputs(shape, torch.bfloat16, seed)
    scale = probe.D ** -0.5
    mask = torch.ones(shape[0], shape[2], dtype=torch.bool, device="cuda")
    fns = {
        "plain": lambda q, k, v: plain_flash_attention(q, k, v, scale),
        "einsum": lambda q, k, v: attention(q * scale, k, v, mask, amp_scores=True),
        "sdpa": lambda q, k, v: F.scaled_dot_product_attention(q, k, v, scale=scale),
    }
    o, lse = flash_forward(q, k, v, scale)
    first, second = (flash_backward(q, k, v, o, lse, g, scale) for _ in range(2))
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(first, second)]
    say(f"[flash check] {shape} bf16 backward twice on the same inputs: dq, dk, dv "
        f"bit-identical {same}")
    if not all(same):
        raise SmokeFailure(f"flash backward is not deterministic: {same}")
    calls = {"kernel": (  # the launches alone, uncounted
        lambda: flash_forward(q, k, v, scale),
        lambda: flash_backward(q, k, v, o, lse, g, scale),
        lambda: flash_backward(q, k, v, *flash_forward(q, k, v, scale), g, scale))}
    for name, fn in fns.items():
        qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
        out = fn(qr, kr, vr)
        calls[name] = (lambda fn=fn: fn(q, k, v).detach(),
                       lambda out=out, qr=qr, kr=kr, vr=vr: torch.autograd.grad(
                           out, (qr, kr, vr), g, retain_graph=True),
                       lambda fn=fn, qr=qr, kr=kr, vr=vr: torch.autograd.grad(
                           fn(qr, kr, vr), (qr, kr, vr), g))
    times, device = {}, {}
    for name, (fwd, bwd, both) in calls.items():
        times[name] = tuple(time_ms(c) for c in (fwd, bwd, both))
        device[name] = tuple(device_ms(c) for c in (fwd, bwd, both))
    elems, s2 = q.numel(), shape[0] * shape[1] * shape[2] ** 2 * shape[3]
    stats = 4 * shape[0] * shape[1] * shape[2]
    mm = lambda flops: {"products": (flops, BF16_FLOPS)}
    bounds = [bound(4 * 2 * elems + stats, mm(4 * s2)),   # q, k, v in; o, lse out
              bound(8 * 2 * elems + stats, mm(10 * s2)),  # q, k, v, o, dO, lse in; dq, dk, dv out
              bound(8 * 2 * elems, mm(14 * s2))]          # q, k, v, dO in; o, dq, dk, dv out
    for i, what in enumerate(("forward", "backward", "forward+backward")):
        say(f"[flash time] {shape} bf16 {what}, ms (CUDA events | device time): " + ", ".join(
            f"{name} {times[name][i]:.4f} | {device[name][i]:.4f}"
            for name in ("kernel", "plain", "einsum", "sdpa"))
            + f"; bound {bounds[i][0]:.4f} ms ({bounds[i][1]})")
    # the host's cost per call of the public wrapper (layout_timing.flash_calls,
    # forward and backward in turns); the parent's, from parent_turns
    host = dict(zip(("forward", "backward"),
                    layout_timing.compare(*layout_timing.flash_calls(flash_module))))
    for direction, t in host.items():
        old = (earlier or {}).get("flash", {}).get(direction)
        say(f"[flash launch] {direction} through flash_attention: host us per call "
            f"{t['host_us']:.2f}" + (f", the parent's {old:.2f} (in turns, layout_timing)"
                                     if old is not None else "")
            + f"; CUDA-event ms {t['ms']:.4f}, device ms {t['device_ms']:.4f}")
    rows = []
    for i, direction in enumerate(("forward", "backward")):
        rows.append({
            "name": f"flash_attention.{direction}", "route": "cuda",
            "source": "mammo_clip_tpu_torch/csrc/flash_attention.cu",
            "replaces": "benchmarks/probe_flash_attention.py:45",
            "launches": counts[f"flash_attention.{direction}"],
            "max_abs_err": errs["probe", "bfloat16"][i], "ms": device["kernel"][i],
            "plain_ms": device["plain"][i], "bound_ms": bounds[i][0], "bound_by": bounds[i][1],
            "library_ms": device["sdpa"][i], "event_ms": times["kernel"][i],
            "host_us": host[direction]["host_us"],
            "earlier_host_us": (earlier or {}).get("flash", {}).get(direction)})
    return rows


# --------------------------------------------------------------------------
# phase 9: the probe kernels
# --------------------------------------------------------------------------

# What benchmarks/probe_mosaic.py prints for its layout probes (the same seeded
# inputs; run on the CPU under pltpu.force_tpu_interpret_mode(), checked against
# the port by tests/test_torch_probes.py). dot_3d fails there (R6).
JAX_LAYOUT_SUMS = {"concat_aligned": 49139.430, "reshape_collapse": 48681.105,
                   "reshape_split": 16.198, "sublane_stack": 16.198,
                   "reshape_collapse_rows10": 60836.828, "reshape_split_rows10": 102.065}


# the const kernel's designs and the channel-mix kernel's load widths, by template argument
PROBE_ARGS = {"grid_const": {"0": "ring", "1": "regs4"},
              "channel_mix": {"1": "vec", "0": "scalar"}}


def probe_label(mangled):
    """'grid_compute', 'grid_const<ring>', 'const_finish', 'channel_mix<vec>' ... for
    the kernels of csrc/probes.cu that phase 9 reports on; None else."""
    m = re.search(r"(grid_compute|grid_const|const_finish|channel_mix)_kernel(?:IL[ib](\d+)E)?",
                  mangled)
    if not m:
        return None
    return m.group(1) + (f"<{PROBE_ARGS[m.group(1)][m.group(2)]}>" if m.group(2) else "")


def probe_kernel_report(C):
    """Phase 9's look at the grid compute, grid const and channel-mix kernels in the
    built library: registers, shared and local memory (cuobjdump), spill stores
    (ptxas), dynamic shared memory and blocks per SM (the compute kernel's at C,
    pr_grid_compute_info; the const ring's, pr_grid_const_info), their HMMA,
    atomic and bulk-copy counts in the SASS (chiprun_out/probes.sass). Fails if
    the compute kernel has no HMMA, any of them an atomic, the const kernel's
    ring no bulk copy, or a const or channel-mix kernel spills."""
    import ctypes

    from mammo_clip_tpu_torch.ops import cuda_lib

    usage, counts, spills = library_report(cuda_lib.build_info.path, cuda_lib.build_info.ptxas,
                                           probe_label, "probes.sass")
    lib = cuda_lib.load()
    smem, blocks, csmem, cblocks = (ctypes.c_int() for _ in range(4))
    for rc, name in ((lib.pr_grid_compute_info(C, ctypes.byref(smem), ctypes.byref(blocks)),
                      "pr_grid_compute_info"),
                     (lib.pr_grid_const_info(ctypes.byref(csmem), ctypes.byref(cblocks)),
                      "pr_grid_const_info")):
        if rc:
            raise SmokeFailure(f"{name} failed with CUDA error {rc}")
    dynamic = {"grid_compute": f"{smem.value} B at C = {C}, blocks per SM {blocks.value}",
               "grid_const<ring>": f"{csmem.value} B, blocks per SM {cblocks.value}"}
    for label in sorted(counts):
        u, (hmma, atomics, bulk) = usage.get(label, {}), counts[label]
        say(f"[probe kernels] {label}: REG {u.get('REG')}, SHARED {u.get('SHARED')}, STACK "
            f"{u.get('STACK')}, LOCAL {u.get('LOCAL')}, spill stores "
            f"{spills.get(label, 'not read (built earlier)')} B, dynamic shared "
            f"{dynamic.get(label, '0 B')}, HMMA {hmma}, atomics {atomics}, bulk copies "
            f"{len(bulk)} {sorted(set(bulk))}")
    faults = [f"{k}: atomics {a}" for k, (_, a, _) in counts.items() if a]
    if counts.get("grid_compute", (0,))[0] == 0:
        faults.append("grid_compute: no HMMA")
    if not counts.get("grid_const<ring>", (0, 0, []))[2]:
        faults.append("grid_const<ring>: no bulk copy")
    faults += [f"{k}: spills {b} B" for k, b in spills.items()
               if k.startswith(("grid_const", "channel_mix")) and int(b)]
    expected = {"grid_compute", "const_finish", "grid_const<ring>", "grid_const<regs4>",
                "channel_mix<vec>", "channel_mix<scalar>"}
    if faults or set(counts) != expected:
        raise SmokeFailure(f"probe kernels' SASS: {faults}, kernels found {sorted(counts)}")


def probe_phases(earlier=None):
    """Phase 9. Returns the grid and layout rows of the kernels line; with
    ``earlier`` (parent_turns'), the grid compute row's earlier_ms."""
    import numpy as np
    import torch

    from mammo_clip_tpu_torch.benchmarks import layout_timing
    from mammo_clip_tpu_torch.benchmarks import probe_mosaic as probe
    from mammo_clip_tpu_torch.ops import probes

    x, k, vec, we = probe.grid_inputs("cuda")
    N, C, H, W = x.shape
    E, blocks = k.shape[0], N * H // probes.ROWS
    # At the probe's inputs the const output is the bank term (~3e8 per channel)
    # to fp32's ~30 of resolution, which hides the x part (~1e3); so the const
    # kernel is checked twice: as is (the bank term), and with vec = -k[:, 0:1, :],
    # which cancels the bank exactly and leaves the x part alone.
    vec0 = (-k[:, 0:1, :]).contiguous()
    # name: wrapper (checked), raw launch (timed, uncounted), plain, tol, bytes, and
    # the operations of each unit that does them (bound's ops): sums off the
    # tensor cores (fp32 peak). The compute kernel's, by the units its code uses:
    # on the tensor cores z = We^T x and the taps' fp32 sums, one m16n8k16 mma
    # (4,096 flop) with a 0/1 selector per tap for 8 channels x 32 columns of a
    # row, 144 flop an output; off them the 9 rounded tap products of an output,
    # two a packed bf16 multiply, which issues at the rate the fp32 peak counts
    # as one FMA of two operations, so 67 T products/s.
    fp32 = lambda n: {"sums": (n, FP32_FLOPS)}
    outputs = N * H * W * E
    grid = {
        "base": (lambda: probes.grid_base(x), lambda: probes.grid_sum_kernel(0, x),
                 lambda: probes.plain_grid_base(x), 1e-4, x.numel() * 2, fp32(x.numel())),
        "halo": (lambda: probes.grid_halo(x), lambda: probes.grid_sum_kernel(1, x),
                 lambda: probes.plain_grid_halo(x), 1e-4, x.numel() * 2,
                 fp32(x.numel() * 1.25)),
        "const": (lambda: probes.grid_const(x, k, vec),
                  lambda: probes.grid_const_kernel(x, k, vec),
                  lambda: probes.plain_grid_const(x, k, vec), 1e-4,
                  x.numel() * 2 + 2 * E * W * 2, fp32(x.numel() + 2 * E * W)),
        "compute": (lambda: probes.grid_compute(x, we, k),
                    lambda: probes.grid_compute_kernel(x, we, k),
                    lambda: probes.plain_grid_compute(x, we, k), 1e-3,
                    x.numel() * 2 + we.numel() * 2 + k.numel() * 2,
                    {"tensor cores (z, tap sums)": (2 * N * H * W * C * E + 144 * outputs,
                                                    BF16_FLOPS),
                     "tap products (bf16x2)": (9 * outputs, FP32_FLOPS)}),
    }
    rows8, wl, flat10 = layout_timing.layout_inputs("cuda")
    n8 = rows8.numel()
    layout = {
        "gram": (lambda: probes.gram_rows(rows8), lambda: probes.plain_gram_rows(rows8),
                 1e-5, 4 * (n8 + 256), fp32(2 * 16 * n8)),
        "copy_scale": (lambda: probes.copy_scale(flat10, (16, 10, 384), 2.0),
                       lambda: probes.plain_copy_scale(flat10, (16, 10, 384), 2.0), 0.0,
                       8 * flat10.numel(), fp32(flat10.numel())),
        "channel_mix": (lambda: probes.channel_mix(rows8, wl),
                        lambda: probes.plain_channel_mix(rows8, wl), 1e-5,
                        8 * n8 + 4 * 256, fp32(2 * 16 * n8)),
    }
    # one PyTorch call of the same function, where there is one (timed as library_ms)
    library = {"base": lambda: torch.sum(x, (0, 2, 3), dtype=torch.float32).view(-1, 1, 1)}
    library.update({name: lib_call for name, (_, lib_call)
                    in layout_timing.layout_calls(probes, rows8, wl, flat10).items()})
    checks = [("grid", name, wrap, plain, tol) for name, (wrap, _, plain, tol, _, _)
              in grid.items()]
    checks.insert(3, ("grid", "const (bank cancelled, x part alone)",
                      lambda: probes.grid_const(x, k, vec0), lambda: probes.plain_grid_base(x),
                      1e-4))
    checks.append(("grid", "compute, all E channel sums",
                   lambda: probes.grid_compute_channel_sums(x, we, k),
                   lambda: probes.plain_grid_compute_channel_sums(x, we, k), 1e-3))
    checks += [("layout", name, wrap, plain, tol) for name, (wrap, plain, tol, _, _)
               in layout.items()]
    errs = {}
    for kind, name, wrap, plain, tol in checks:
        a, b = wrap(), plain()
        torch.cuda.synchronize()
        errs[name] = (max_rel(a, b), float((a - b).abs().max()))
        say(f"[probe check] {kind} {name}: {errs[name][0]:.2e}/{tol:.0e}, "
            f"max |diff| {errs[name][1]:.3e}")
        if not errs[name][0] <= tol:
            raise SmokeFailure(f"probe kernel {name} disagrees with plain: {errs[name]}")
    for name, call in library.items():
        plain = grid[name][2] if name in grid else layout[name][1]
        err = max_rel(call(), plain())
        say(f"[probe check] library call for {name} against the plain version: {err:.2e}")
        if not err <= 1e-5:
            raise SmokeFailure(f"the library call for {name} computes another function: {err}")
    gram_bits = [probes.gram_rows(rows8) for _ in range(2)]
    if not torch.equal(*gram_bits):
        raise SmokeFailure("two calls of the Gram kernel on the same input gave other bits")
    say("[probe check] two Gram kernel calls on the same input: the same bits")
    twice = {"grid compute (all E channel sums)": lambda: probes.grid_compute_channel_sums(x, we, k),
             "grid const": lambda: probes.grid_const(x, k, vec),
             "grid const (bank cancelled)": lambda: probes.grid_const(x, k, vec0),
             "channel mix": lambda: probes.channel_mix(rows8, wl)}
    for name, call in twice.items():
        if not torch.equal(call(), call()):
            raise SmokeFailure(f"two calls of the {name} kernel on the same input gave other bits")
        say(f"[probe check] two {name} kernel calls on the same input: the same bits")
    probe_kernel_report(C)
    x3, w3 = rows8.cpu().numpy(), wl.cpu().numpy()
    want = np.einsum("chw,cd->hdw", x3, w3)
    mix_err = float(np.abs(probes.channel_mix(rows8, wl).cpu().numpy() - want).max())
    say(f"[probe check] dot_3d intended function (R6) vs numpy einsum: max |diff| {mix_err:.2e}")
    if not mix_err <= 1e-4 * np.abs(want).max():
        raise SmokeFailure(f"channel_mix disagrees with numpy: {mix_err}")

    probes.launches.reset()
    res = probe.main([])
    counts = dict(probes.launches.counts)
    say(f"[probe path] probe_mosaic (all probes): counters {counts}")
    if min(counts.values()) < 1:
        raise SmokeFailure(f"probe path launched no kernel of some probe: {counts}")
    for name, want_sum in JAX_LAYOUT_SUMS.items():
        got = float(res[name].sum())
        say(f"[probe sums] {name}: card {got:.3f}, JAX script (interpret mode) {want_sum:.3f}")
        if abs(got - want_sum) > 1e-5 * abs(want_sum) + 2e-3:
            raise SmokeFailure(f"layout probe {name}: sum {got} vs the JAX script's {want_sum}")
    timed = {("grid", name): (raw, plain, nbytes, ops)
             for name, (_, raw, plain, _, nbytes, ops) in grid.items()}
    timed.update({("layout", name): (wrap, plain, nbytes, ops)
                  for name, (wrap, plain, _, nbytes, ops) in layout.items()})
    # the card's least device time per launch: a one-thread kernel that does nothing
    empty_ms = layout_timing.device_ms(probes.empty_kernel, reps=100)
    say(f"[probe time] empty kernel: device {empty_ms:.4f} ms per launch")
    # the const kernel's yardstick: no single PyTorch call computes it; the sum of x
    # and the bank term, two reductions and the arithmetic between them
    composite = lambda: torch.sum(x, (0, 2, 3), dtype=torch.float32).view(-1, 1, 1) + N * H * W * (
        k[:, 0, :].sum(dtype=torch.float32) + vec.sum(dtype=torch.float32))
    err = max_rel(composite(), probes.plain_grid_const(x, k, vec))
    say(f"[probe check] the const composite (torch.sum of x plus the bank term) against the plain "
        f"version: {err:.2e}")
    if not err <= 1e-5:
        raise SmokeFailure(f"the const composite computes another function: {err}")
    rows = []
    for (kind, name), (kern, plain, nbytes, ops) in timed.items():
        plain_ms = time_ms(plain, reps=3)
        if kind == "layout":
            # host-bound at this size: the median of 5 x 200 calls, device time
            # and the host's cost per call, for the kernel and its library call
            ours, lib_t = layout_timing.compare(kern, library[name])
            ms, library_ms = ours["ms"], lib_t["ms"]
        else:
            ms = time_ms(kern)
            library_ms = time_ms(library[name]) if name in library else None
        bound_ms, bound_by, which = bound(nbytes, ops)
        per_block = f", {ms * 1e3 / blocks:.3f} us per block" if kind == "grid" else ""
        lib_txt = f"{library_ms:.4f} ms" if library_ms is not None else "none"
        say(f"[probe time] {kind} {name}: kernel {ms:.4f} ms{per_block}, plain "
            f"{plain_ms:.4f} ms, library {lib_txt}, bound {bound_ms:.4f} ms ({which})")
        line = {"grid": {"base": "193", "halo": "209", "const": "231", "compute": "259"},
                "layout": dict.fromkeys(layout, "27")}[kind][name]
        err = errs[name][1]
        if name == "const":
            err = max(err, errs["const (bank cancelled, x part alone)"][1])
        if name == "compute":
            err = max(err, errs["compute, all E channel sums"][1])
        row = {
            "name": f"probe_{kind}[{name}]", "route": "cuda",
            "source": "mammo_clip_tpu_torch/csrc/probes.cu",
            "replaces": f"benchmarks/probe_mosaic.py:{line}",
            "launches": counts[f"probe_{kind}.{name}"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}
        if kind == "grid" and name != "halo":
            row["earlier_ms"] = earlier[f"grid_{name}"] if earlier else None
        if name == "const":
            row["composite_ms"] = time_ms(composite)
            say(f"[probe time] grid const: the composite (torch.sum plus the bank term) "
                f"{row['composite_ms']:.4f} ms")
        if kind == "layout":
            say(f"[probe time] layout {name}: kernel device {ours['device_ms']:.4f} ms, host "
                f"{ours['host_us']:.2f} us per call; library device {lib_t['device_ms']:.4f} ms,"
                f" host {lib_t['host_us']:.2f} us per call")
            row.update(device_ms=ours["device_ms"], host_us=ours["host_us"],
                       library_device_ms=lib_t["device_ms"], library_host_us=lib_t["host_us"],
                       empty_device_ms=empty_ms)
            if name == "channel_mix":
                old = (earlier or {}).get("channel_mix", {})
                row.update(earlier_ms=old.get("ms"), earlier_device_ms=old.get("device_ms"),
                           earlier_host_us=old.get("host_us"))
        rows.append(row)
    return rows

# --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", type=Path, default=None,
                    help="an older checkout of the port whose e6 form is timed beside this one")
    args = ap.parse_args(argv)

    if not (ROOT / "mammo_clip_tpu_torch" / "csrc").is_dir():
        raise SmokeFailure("run chip_smoke.py from a checkout of the repository "
                           "(mammo_clip_tpu_torch/ not found beside it)")
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: chip_smoke.py runs on an NVIDIA card")
    sys.path.insert(0, str(ROOT))
    from mammo_clip_tpu_torch.ops import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    OUT_DIR.mkdir(exist_ok=True)

    # 1. environment
    card = card_line()
    say(card)
    build_empty = not any(cuda_lib.BUILD_DIR.glob("*")) if cuda_lib.BUILD_DIR.exists() else True
    say(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"build dir empty at start: {build_empty}")

    # 2. build
    cuda_lib.build(ptxas_verbose=True)
    info = cuda_lib.build_info
    say(f"[build] {info.path.name}: {info.seconds:.1f} s (compiled now: {info.compiled})")
    if info.ptxas:
        (OUT_DIR / "ptxas.log").write_text(info.ptxas)
        used = re.findall(r"Used (\d+) registers", info.ptxas)
        spills = re.findall(r"(\d+) bytes spill stores", info.ptxas)
        say(f"[build] ptxas: {len(used)} kernels, registers max {max(map(int, used), default=0)}"
            f", spill stores max {max(map(int, spills), default=0)} B "
            f"(full log chiprun_out/ptxas.log)")
    cuda_lib.load()

    # 3-4. kernel against plain version at the main path's shapes, then times
    kernels, e6_e1_form = kernel_phases(args.seed)
    earlier = parent_turns(args.parent) if args.parent else None

    # 5. reference on a small input, then the slice
    reference_check(args.seed)
    rows = run_slice(args.seed)
    peak = max(r["peak_bytes"] for r in rows)
    if earlier:
        say(f"[slice] peak memory {peak} B ({peak / 2**30:.2f} GiB); in e6_timing's processes: "
            f"the parent's {earlier['old_peak']} B ({earlier['old_peak'] / 2**30:.2f} GiB), "
            f"this package's {earlier['new_peak']} B ({earlier['new_peak'] / 2**30:.2f} GiB)")

    # 6. the standalone e1 kernel; 7. the pretraining entry point; 10. serving on its run
    e1_rows = e1_phases(args.seed, e6_e1_form)
    cli, cli_tmp = run_cli(args.seed)
    try:
        serving = serving_phase(args.seed, cli_tmp / "run")
        # 11. the downstream classifier, on the same run's best/
        clf = classifier_phase(args.seed, cli_tmp / "run")
        # 12. detection, on the same run's best/
        det = detector_phase(args.seed, cli_tmp / "run")
    finally:
        shutil.rmtree(cli_tmp, ignore_errors=True)
    (OUT_DIR / "chip_smoke_steps.json").write_text(
        json.dumps(dict(slice=rows, cli=cli, serving=serving, classifier=clf, detector=det),
                   indent=1))

    # 8. flash attention; 9. the probe kernels
    flash_rows = flash_phases(args.seed, earlier)
    probe_rows = probe_phases(earlier)

    lines = []
    for k in kernels:
        direction = k["direction"]
        err_out, err_dx = k["err"]
        lines.append({
            "name": f"fused_mbconv_e6[{k['case']}].{direction}",
            "route": "cuda",
            "source": "mammo_clip_tpu_torch/csrc/mbconv6_e6.cu",
            "replaces": "mammo_clip_tpu/ops/mbconv6_pallas.py:"
                        + ("536" if direction == "forward" else "702"),
            "launches": cli["counts"][f"mbconv6.{k['form']}.{direction}"],
            "max_abs_err": err_out if direction == "forward" else err_dx,
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
        })
        lines[-1]["earlier_ms"] = earlier[k["case"]][direction] if earlier else None
    for k in e1_rows:
        direction = k["direction"]
        err_out, err_dx = k["err"]
        lines.append({
            "name": f"fused_mbconv_e1[{k['case']}].{direction}",
            "route": "cuda",
            "source": "mammo_clip_tpu_torch/csrc/mbconv6_e6.cu",
            "replaces": "mammo_clip_tpu/ops/mbconv_pallas.py:"
                        + ("476" if direction == "forward" else "577"),
            "launches": k["launches"],
            "max_abs_err": err_out if direction == "forward" else err_dx,
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None, "event_ms": k["event_ms"],
        })
        old = (earlier or {}).get(f"{k['case']}_e1_entry")
        lines[-1]["earlier_ms"] = old[direction + "_device"] if old else None
    for k in clf["kernels"]:  # the ft arm's path: N=8, fp32
        direction = k["direction"]
        err_out, err_dx = k["err"]
        lines.append({
            "name": f"fused_mbconv_e6[{k['case']}].{direction}",
            "route": "cuda",
            "source": "mammo_clip_tpu_torch/csrc/mbconv6_e6.cu",
            "replaces": "mammo_clip_tpu/ops/mbconv6_pallas.py:"
                        + ("536" if direction == "forward" else "702"),
            "launches": clf["fused_counts"].get(f"mbconv6.{k['form']}.{direction}", 0),
            "max_abs_err": err_out if direction == "forward" else err_dx,
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
        })
    lines += flash_rows + probe_rows
    say(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    say(json.dumps({"kernels": lines}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
