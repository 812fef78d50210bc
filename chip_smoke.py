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
 13. offline preprocessing into training, on phase 7's run, whose directory is
     kept until this phase ends (host code: numpy and the port's C++ library,
     built with g++; the card runs the training it feeds): (a) the native
     library built from ``preprocess/native/`` (its seconds; a failed build
     fails the phase, no numpy fallback), and whether the GDCM headers are
     there; (b) 12 seeded synthetic uint16 mammograms at RSNA scale,
     2800x2300 (a breast-shaped region on the left or right, MONOCHROME1 and
     2 mixed, a burned-in border the 5-pixel trim removes): the native
     normalize bit-equal to its plain version, the native crop bounds equal to
     ``breast_roi_bounds``, the fused pipeline's bounds equal and its resize to
     1520x912 within 1 grey level of the plain version (the count of pixels
     that differ printed), ms per image native against plain beside the host
     CPU's model and cores; (c) with GDCM: each image written as a DICOM in
     the four transfer syntaxes and read back bit-exact, ``dicom_tool.main``
     through the pool and with ``--threads 1`` (shards and bounds CSVs
     byte-equal, and equal to (b)'s images), the pool's images/s at 1 thread
     and at all threads; without GDCM a line says so and (b)'s native outputs
     stand for the tool's, their bounds CSV written by ``write_table``; (d)
     shards at 1520x912 and 512x512 through ``write_packed_shards``, read back
     bit-equal through ``open_image_store``; (e) a pretraining CSV built from
     synthetic report rows (``build_pretrain_rows``, ``assign_group_folds``,
     ``augment_pretrain_csv``, ``write_table``) and ``cli/pretrain --device
     cuda`` on it with the 1520x912 shards as ``image_dir``: the compat B5
     recipe with the fused route and remat on, batch 2, 1 epoch of 3 steps;
     finite losses, 14 forward and 14 backward fused calls a step, and every
     image read from those shards; (f) a detection CSV from boxes drawn in the
     original frame, rescaled by ``rescale_detection_boxes`` through the
     bounds CSV to 512x512 (every box inside the frame), and ``cli/detector``
     on the 512x512 shards from phase 7's ``best/``, batch 4, 1 epoch: finite
     losses, ``best_mAP`` in [0, 1], every validation image scored, every
     image read from those shards; (g) a PNG tree of the 1520x912 images
     written by the port's encoder (rows filtered with all five types) read
     through ``DirectoryImageStore`` bit-equal, its 512x512 resize equal to
     the native area resize, and the native PNG unfilter equal to its plain
     version; (h) the phase's seconds beside the card's name and power limit;
 14. the flagship pretraining path (no hand kernel lies on it: the fused route
     is refused under ``tpu_optimized``), on phase 7's run, whose directory is
     kept until this phase ends: (a) the tiny flagship CLIP (b0 at 64x48,
     fp32) on the card against the CPU from the same weights: eval and train
     embeddings within 1e-3, the loss, the gradients' relative norm and the
     loss after one AdamW step within 1e-3 (the update's own distance
     printed); (b) the flagship bench step at full width
     (``bench_recipe_config(compat=False)``: B5 ``tpu_optimized`` at 1520x912,
     no remat, BERT-base with bf16 attention scores, bf16 activations, batch
     8, K=5 steps a call through ``build_bench_train``): one warm-up call and
     2 timed calls (host clock ending in a synchronise), ms a step, images/s
     (16 views a step) and peak memory, a step that does not fit the card
     failing the phase; (c) the ``--trimmed`` recipe, one call of 5 steps,
     timed; (d) ``cli/pretrain`` with the flagship overrides
     (``model.image_encoder.tpu_optimized=true``, ``train.steps_per_call=5``,
     ``optimizer.warm_start_lr_scale=0.25``; 14 rows at batch 2: 1 call of 5
     steps an epoch) and ``--warm-start-from`` phase 7's ``best/``, 1 epoch,
     then ``--resume`` to 2: the config equal to the recipe's, the peak LR
     scaled by 0.25, every tensor right after the warm start equal to
     ``warm_start_state_dict`` of that checkpoint (the fresh ones unchanged),
     how many were seeded and kept fresh, finite losses, the checkpoints;
     (e) ``cli/zeroshot`` (16 rows at 1520x912) and ``cli/detector`` (512x512,
     batch 7, 1 epoch; its FPN built on the flagship's 128, 512 and 2048
     channels) on (d)'s ``best/``; the fused counters read 0 over (b)-(e);
     (f) the phase's seconds beside the card's name and power limit;
 15. the other image-encoder families and Mammo-FActOR, on phase 7's run,
     whose directory is kept until this phase ends (the hand flash-attention
     kernel runs every ViT layer's attention, forward and backward): (a) the
     flash kernel at the ViT-B/16 step's shape, (2, 12, 5416, 64) (95 x 57
     patches and the CLS token at 1520x912, 12 heads of 64), against its plain
     version in fp32 and bf16 (out, dq, dk, dv; phase 8's tolerances; SDPA's
     own distance printed beside the bf16 row), then its times beside the
     plain version's, the einsum attention's and SDPA's, and its bound (4 B N
     S^2 D products at the bf16 tensor-core peak against the bytes at the HBM
     rate); (b) a tiny CLIP of each family (ViT, Swin with a shifted stage and
     a merge, ResNet-50; 64x64) on the card and on the CPU from one state
     dict, fp32: eval embeddings, the loss and the gradients' relative norm
     (1e-3; ResNet-50's whole step 5e-2, since ReLU and max-pool decisions
     that flip under rounding make it ill-conditioned, which the CPU's own
     step under a 1e-6 change of the images shows, and its 53 conv +
     train-mode BatchNorm pairs one by one on the same inputs at 1e-3), the
     flash counters 6 + 4 on the card's ViT and 0 on the CPU; (c) ``bench_recipe_config(compat=True)``
     with BERT-base at batch 2 and each family's encoder at full width:
     ViT-B/16 at 1520x912, Swin-T at 1536x1024 (1520x912 does not divide by
     patch x window x 2^3 = 256), ResNet-101 at 1520x912: one warm-up step
     and 5 timed, ms a step, images/s, peak memory, the flash counters 24 + 24
     a ViT step (0 for the others) and the fused MBConv counters 0; (d)
     ``cli/pretrain`` with ``model.image_encoder.name=vit-base`` (1 epoch of 2
     steps, then ``--resume`` to 2), ``cli/zeroshot`` and ``cli/classifier
     --arch lp`` on its ``best/`` (flash forward only in these two); (e)
     ``cli/factor`` on phase 7's B5 ``best/`` at 1520x912 (both attributes, 16
     positive rows, batch 8, 2 epochs; the (8, 48, 29, 2048) features read as
     2048 regions of 1392 positions): a finite loss, the mapper saved, its
     seconds; (f) ViT-B/16 and Swin-T drawn on the card, their tensors written
     under HF's ``ViTModel`` / ``SwinModel`` names (no ``transformers``), read
     back through ``convert_hf_vit`` / ``convert_hf_swin``: every tensor equal
     and the same bits out at full width; (g) the phase's seconds beside the
     card's name and power limit;
 16. int8 k5 convs, the serving export and profiling, on phase 7's run: (a)
     ``int8_conv1x1`` (``ops/quant.py``; its int32 product is
     ``torch._int_mm``, no hand kernel) at B5's k5 1x1 shapes at 1520x912,
     batch 16 (each of stages 3, 5 and 6: the entry expand, an in-stage expand
     and project), card vs CPU (int8 operands and scale equal, the product's
     first rows to 1 ulp, the straight-through backward at stage 6 to 1e-5),
     its time beside ``torch._int_mm`` alone and a bf16 ``torch.matmul`` of
     the same shape; (b) phase 7's B5 ``best/`` with ``quant_int8_k5`` in eval
     mode, fp32: card vs CPU on 2 images, images/s and peak memory at batch 16
     beside phase 10's fp32 figures, the cosine to the fp32 embeddings
     (information); (c) the compat step with ``quant_int8_k5`` (21 int8
     blocks) and the fused route, 3 steps at batch 2: finite losses, 14 + 14
     fused calls a step, ms beside phase 5's; (d) ``cli/export`` on that
     ``best/`` (batch 8, cuda), the artifact loaded and called in a fresh
     process that cannot import this package, its embeddings against
     ``EmbeddingExtractor``'s (1e-4), export and load seconds, ms a batch
     beside the eager extractor's; (e) a ViT-B/16 CLIP exported on the card
     at 1520x912, batch 2, fp32: 12 nodes of the flash operator and no
     softmax or SDPA in its image program, one call of the loaded artifact
     launching the kernel 12 times, its embeddings against the eager model's
     (1e-4); (f) ``utils/profiling.profile_trace`` around one call of that
     artifact in a fresh process (its ``requires`` imported): the trace holds
     12 or more flash forward kernels and the counters 12; (g) the phase's
     seconds;
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
e1, flash and probe entries on their own paths, the flash entries at the ViT
shape on phase 15 (c)'s ViT-B/16 steps); the last line is
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
import textwrap
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


def pretrain_overrides(csv_path, image_dir, seed):
    """cli/pretrain's dotted overrides that make the default B5 config the
    compat recipe with the fused route and remat on, at batch BATCH."""
    entry = json.dumps([{"csv": str(csv_path), "image_dir": str(image_dir),
                         "data_type": "imagetext"}])
    return ["model.image_encoder.remat=true", "model.image_encoder.fused_mbconv=true",
            f"data.train={entry}", f"data.valid={entry}",
            f"data.batch_size_per_device={BATCH}", "scheduler.warmup_epochs=0",
            "train.log_every=1", f"seed={seed}"]


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
        workdir = tmp / "run"
        flags = ["--workdir", str(workdir), "--device", "cuda"]
        overrides = pretrain_overrides(csv_path, "synthetic://", seed)
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
# phase 13: offline preprocessing into training
# --------------------------------------------------------------------------

PRE_IMAGES = 12
PRE_RAW = (2800, 2300)  # RSNA-scale raw frames (benchmarks/bench_preprocess.py:31-32)
PRE_SIZE = (1520, 912)  # the B5 recipe's input
PRE_DET = (DET_SIZE, DET_SIZE)
PRE_TRIM = 5  # dicom_tool's edge trim
PRE_DET_BATCH = 4
PRE_REPORTS = [
    ("There is a mass in the upper outer quadrant of the breast. Scattered fibroglandular "
     "densities are seen.", "No mammographic evidence of malignancy is seen."),
    ("Grouped calcifications are noted in the subareolar region. The skin is unremarkable.",
     "Findings are suspicious for malignancy and a biopsy is advised."),
    ("The breast is heterogeneously dense. No suspicious mass is identified.",
     "Benign findings are stable compared to prior."),
]


def host_cpu() -> str:
    """The host CPU's model and its cores, as this process sees them."""
    import os
    import platform

    model = ""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                model = line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    return (f"host CPU {model or 'unknown'} ({platform.machine()}), {os.cpu_count()} cores, "
            f"{len(os.sched_getaffinity(0))} usable")


def raw_mammograms(seed, n=PRE_IMAGES, shape=PRE_RAW):
    """n seeded uint16 frames of 12-bit values: a textured breast-shaped
    half-ellipse on the left (even k) or right side over background noise,
    and a burned-in 3-pixel border that the trim removes; every third frame is
    MONOCHROME1 (stored inverted). Returns [(frame, monochrome1, laterality)]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = shape
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    out = []
    for k in range(n):
        lat = "L" if k % 2 == 0 else "R"
        cx = 0.0 if lat == "L" else w - 1.0
        ry, rx = h * rng.uniform(0.36, 0.46), w * rng.uniform(0.5, 0.75)
        cy = h * rng.uniform(0.45, 0.55)
        inside = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 < 1
        texture = 2200 + 600 * np.sin(yy / rng.uniform(30, 90)) * np.cos(xx / rng.uniform(30, 90))
        noise = rng.normal(0, 120, shape).astype(np.float32)
        frame = np.where(inside, texture + noise, np.abs(noise) * 0.8)
        frame[:3], frame[-3:], frame[:, :3], frame[:, -3:] = 4095, 4095, 4095, 4095
        v = np.clip(frame, 0, 4095).astype(np.uint16)
        mono1 = k % 3 == 0
        out.append((4095 - v if mono1 else v, mono1, lat))
    return out


def preprocess_host(seed, tmp, n=PRE_IMAGES, shape=PRE_RAW, size=PRE_SIZE, det=PRE_DET):
    """Phase 13's host steps (a)-(d) and (g) and its CSVs, in ``tmp``; the
    card steps (e) and (f) read what this writes. Fails on any mismatch."""
    import numpy as np

    from mammo_clip_tpu_torch.data import images
    from mammo_clip_tpu_torch.data.metadata import Table, load_metadata, write_table
    from mammo_clip_tpu_torch.data.png import encode_png, write_png
    from mammo_clip_tpu_torch.preprocess import dicom_native, dicom_tool, native_bindings as nb
    from mammo_clip_tpu_torch.preprocess import text, vindr_csv, write_packed_shards
    from mammo_clip_tpu_torch.preprocess.breast_crop import breast_roi_bounds

    out = {}
    # (a) build: a failed build fails the phase
    path = nb.build_native()
    out["build_s"] = nb.build_info["mammo_native"].seconds
    line = (f"[pre] (a) g++ build of {path.name}: {out['build_s']:.2f} s (compiled now: "
            f"{nb.build_info['mammo_native'].compiled})")
    if not nb.native_available():
        raise SmokeFailure("the native preprocessing library does not load")
    gdcm = dicom_native.gdcm_found()
    if gdcm:
        path = dicom_native.build_dicom()
        line += f", {path.name} {nb.build_info['mammo_dicom'].seconds:.2f} s"
        if not dicom_native.dicom_available():
            raise SmokeFailure("the native DICOM library does not load")
    say(f"{line}; GDCM headers in {dicom_native.gdcm_include()}: "
        f"{'found' if gdcm else 'not found'}")

    # (b) native against plain at RSNA scale
    t = time.perf_counter()
    frames = raw_mammograms(seed, n, shape)
    ids = [f"m{k:02d}" for k in range(n)]
    say(f"[pre] (b) {n} seeded {shape[0]}x{shape[1]} uint16 frames "
        f"({sum(f[1] for f in frames)} MONOCHROME1) made in {time.perf_counter() - t:.1f} s")
    native_ms, plain_ms, big, bounds, n_diff, max_diff = [], [], {}, {}, 0, 0
    for image_id, (raw, mono1, _) in zip(ids, frames):
        trimmed = np.ascontiguousarray(raw[PRE_TRIM:-PRE_TRIM, PRE_TRIM:-PRE_TRIM])
        norm = nb.normalize_native(trimmed, mono1)
        if not np.array_equal(norm, nb.normalize_u16_to_u8_plain(trimmed, mono1)):
            raise SmokeFailure(f"{image_id}: native normalize != its plain version")
        if nb.breast_crop_bounds_native(norm) != breast_roi_bounds(norm):
            raise SmokeFailure(f"{image_id}: native crop bounds != breast_roi_bounds")
        t = time.perf_counter()
        img, b = nb.preprocess_mammogram_native(trimmed, size, mono1)
        native_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        ref, ref_b = nb.preprocess_mammogram_plain(trimmed, size, mono1)
        plain_ms.append((time.perf_counter() - t) * 1e3)
        diff = np.abs(img.astype(np.int16) - ref)
        n_diff += int((diff > 0).sum())
        max_diff = max(max_diff, int(diff.max()))
        if b != ref_b or diff.max() > 1:
            raise SmokeFailure(f"{image_id}: fused pipeline bounds {b} vs {ref_b}, resize "
                               f"max |diff| {diff.max()} (limit 1)")
        if b[1] - b[0] >= trimmed.shape[0] and b[3] - b[2] >= trimmed.shape[1]:
            raise SmokeFailure(f"{image_id}: the breast crop kept the whole frame {b}")
        big[image_id], bounds[image_id] = img, b
    out.update(native_ms=native_ms, plain_ms=plain_ms, resize_pixels_differing=n_diff)
    say(f"[pre] (b) native against plain: normalize bit-equal, bounds equal, the fused "
        f"resize to {size[0]}x{size[1]} within {max_diff} grey level ({n_diff} of "
        f"{n * size[0] * size[1]} pixels differ); ms per image native "
        f"{np.median(native_ms):.1f} (median of {n}), plain {np.median(plain_ms):.1f}; "
        f"{host_cpu()}")

    # (c) DICOM
    bounds_csv = tmp / "bounds.csv"
    if gdcm:
        t = time.perf_counter()
        syntaxes = [dicom_native.TS_RAW, dicom_native.TS_J2K, dicom_native.TS_JLS,
                    dicom_native.TS_JPEG_LOSSLESS]
        (tmp / "syntaxes").mkdir()
        (tmp / "dicoms").mkdir()
        for k, (image_id, (raw, mono1, _)) in enumerate(zip(ids, frames)):
            for ts in syntaxes:
                p = tmp / "syntaxes" / f"{image_id}_{ts}.dcm"
                dicom_native.write_dicom_u16(str(p), raw, ts=ts, monochrome1=mono1)
                back, back_mono1 = dicom_native.read_dicom_u16(str(p))
                if not np.array_equal(back, raw) or back_mono1 != mono1:
                    raise SmokeFailure(f"{p.name}: the DICOM round trip is not bit-exact")
            (tmp / "syntaxes" / f"{image_id}_{syntaxes[k % 4]}.dcm").rename(
                tmp / "dicoms" / f"{image_id}.dcm")
        say(f"[pre] (c) {n} x 4 DICOMs (raw, JPEG-2000, JPEG-LS, JPEG lossless) written and "
            f"read back bit-exact in {time.perf_counter() - t:.1f} s")
        common = ["--in-dir", str(tmp / "dicoms"), "--height", str(size[0]), "--width",
                  str(size[1])]
        dicom_tool.main(common + ["--out-dir", str(tmp / "tool_pool"), "--bounds-csv",
                                  str(bounds_csv)])
        dicom_tool.main(common + ["--out-dir", str(tmp / "tool_serial"), "--threads", "1",
                                  "--bounds-csv", str(tmp / "bounds_serial.csv")])
        for f in sorted((tmp / "tool_pool").iterdir()):
            if f.read_bytes() != (tmp / "tool_serial" / f.name).read_bytes():
                raise SmokeFailure(f"dicom_tool: {f.name} differs between the pool and "
                                   f"--threads 1")
        if bounds_csv.read_bytes() != (tmp / "bounds_serial.csv").read_bytes():
            raise SmokeFailure("dicom_tool: the bounds CSVs of the pool and --threads 1 differ")
        store = images.open_image_store(str(tmp / "tool_pool"))
        for image_id in ids:
            if not np.array_equal(store.get("", image_id), big[image_id]):
                raise SmokeFailure(f"dicom_tool: {image_id} differs from (b)'s native image")
        paths = sorted(str(p) for p in (tmp / "dicoms").iterdir())
        rates = {}
        for threads in (1, 0):
            t = time.perf_counter()
            _, _, status = dicom_native.batch_preprocess(paths, size, n_threads=threads)
            rates[threads] = len(paths) / (time.perf_counter() - t)
            if status.any():
                raise SmokeFailure(f"the DICOM pool failed: status {status.tolist()}")
        out["pool_images_per_s"] = rates
        say(f"[pre] (c) dicom_tool through the pool and with --threads 1: shards and bounds "
            f"CSVs byte-equal; the pool {rates[1]:.2f} images/s at 1 thread, {rates[0]:.2f} "
            f"at all threads; {host_cpu()}")
    else:
        say(f"[pre] (c) GDCM headers not found in {dicom_native.gdcm_include()}: no DICOM "
            f"codec on this machine; the raw arrays went through preprocess_mammogram_native "
            f"with the same {PRE_TRIM}-pixel trim in (b)")
        write_table(Table([{"image_id": i, "y0": b[0], "y1": b[1], "x0": b[2], "x1": b[3]}
                           for i, b in bounds.items()], dicom_tool.BOUNDS_COLUMNS),
                    str(bounds_csv))

    # (d) shards at both sizes, read back bit-equal
    small = {}
    for image_id, (raw, mono1, _) in zip(ids, frames):
        trimmed = np.ascontiguousarray(raw[PRE_TRIM:-PRE_TRIM, PRE_TRIM:-PRE_TRIM])
        small[image_id], b = nb.preprocess_mammogram_native(trimmed, det, mono1)
        if b != bounds[image_id]:
            raise SmokeFailure(f"{image_id}: bounds differ between output sizes")
    for name, imgs, hw in (("shards", big, size), ("shards_det", small, det)):
        t = time.perf_counter()
        index = write_packed_shards([(i, i) for i in ids], str(tmp / name), hw, shard_size=5,
                                    loader=imgs.__getitem__)
        store = images.open_image_store(str(tmp / name))
        if not isinstance(store, images.PackedShardStore) or len(index) != n:
            raise SmokeFailure(f"{name}: not read back as packed shards")
        for i in ids:
            if not np.array_equal(store.get("", i), imgs[i]):
                raise SmokeFailure(f"{name}: {i} does not read back bit-equal")
        say(f"[pre] (d) {n} images at {hw[0]}x{hw[1]} -> {1 + (n - 1) // 5} shards "
            f"({sum(f.stat().st_size for f in (tmp / name).iterdir())} B) in "
            f"{time.perf_counter() - t:.2f} s, read back bit-equal through open_image_store")

    # the pretraining CSV from report rows; the detection CSV from boxes drawn in
    # the original (trimmed) frame, rescaled through the tool's bounds
    reports = []
    for k, (image_id, (_, _, lat)) in enumerate(zip(ids, frames)):
        findings, impressions = PRE_REPORTS[(k // 2) % len(PRE_REPORTS)]
        reports.append({"patient_id": str(1000 + k // 2), "laterality": lat,
                        "image_id": image_id, "view_position": ("CC", "MLO")[(k // 2) % 2],
                        "findings": findings, "impressions": impressions})
    write_table(Table(reports, list(reports[0])), str(tmp / "reports.csv"))
    t = time.perf_counter()
    translator = text.BackTranslator()  # MarianMT when transformers and its weights are here
    rows = text.build_pretrain_rows(load_metadata(str(tmp / "reports.csv")),
                                    view_col="view_position")
    rows = text.augment_pretrain_csv(text.assign_group_folds(rows, n_folds=2, seed=seed),
                                     translator)
    write_table(rows, str(tmp / "pretrain.csv"))
    n_train = sum(r["fold"] != 0 for r in load_metadata(str(tmp / "pretrain.csv")))
    if len(rows) != n or n_train != STEPS * BATCH:
        raise SmokeFailure(f"pretraining CSV: {len(rows)} rows, {n_train} training")
    say(f"[pre] pretraining CSV: {len(rows)} rows (6 patients x L/R), {n_train} training, text "
        f"augmented by {'MarianMT' if translator.available else 'RuleParaphraser'},"
        f" in {time.perf_counter() - t:.2f} s")
    ann = []
    for k, image_id in enumerate(ids):
        y0, y1, x0, x1 = bounds[image_id]
        for j in range(1 + (k % 3 == 0)):
            bx0 = x0 + (x1 - x0) * (0.15 + 0.3 * j)
            by0 = y0 + (y1 - y0) * (0.3 + 0.1 * (k % 4))
            ann.append({"study_id": str(1000 + k // 2), "image_id": image_id,
                        "finding_categories": str([DET_CLASSES[(k + j) % 4]]),
                        "xmin": round(bx0, 1), "ymin": round(by0, 1),
                        "xmax": round(bx0 + 0.2 * (x1 - x0), 1),
                        "ymax": round(by0 + 0.15 * (y1 - y0), 1),
                        "split": "training" if k < n - PRE_DET_BATCH else "test"})
    write_table(Table(ann, list(ann[0])), str(tmp / "annotations.csv"))
    det_rows = vindr_csv.rescale_detection_boxes(load_metadata(str(tmp / "annotations.csv")),
                                                 load_metadata(str(bounds_csv)), out_size=det)
    for r in det_rows:
        box = [float(r[c]) for c in vindr_csv.BOX_COLUMNS]
        if not (0 <= box[0] < box[2] <= det[1] - 1 and 0 <= box[1] < box[3] <= det[0] - 1):
            raise SmokeFailure(f"{r['image_id']}: rescaled box {box} outside the "
                               f"{det[0]}x{det[1]} frame")
    write_table(det_rows, str(tmp / "det.csv"))
    say(f"[pre] detection CSV: {len(det_rows)} boxes on {n} images, rescaled to "
        f"{det[0]}x{det[1]}, every box inside the frame")

    # (g) a PNG tree written by the port's encoder (all five row filters)
    t = time.perf_counter()
    for r in reports:
        (tmp / "pngs" / r["patient_id"]).mkdir(parents=True, exist_ok=True)
        write_png(tmp / "pngs" / r["patient_id"] / f"{r['image_id']}.png", big[r["image_id"]],
                  level=1, filters=(0, 1, 2, 3, 4))
    t_write = time.perf_counter() - t
    full = images.open_image_store(str(tmp / "pngs"))
    resized = images.DirectoryImageStore(str(tmp / "pngs"), det)
    if not isinstance(full, images.DirectoryImageStore):
        raise SmokeFailure("the PNG tree did not open as a DirectoryImageStore")
    t = time.perf_counter()
    for r in reports:
        if not np.array_equal(full.get(r["patient_id"], f"{r['image_id']}.png"),
                              big[r["image_id"]]):
            raise SmokeFailure(f"PNG tree: {r['image_id']} is not bit-equal to its source")
    t_read = time.perf_counter() - t
    for r in reports:
        if not np.array_equal(resized.get(r["patient_id"], f"{r['image_id']}.png"),
                              nb.area_resize_native(big[r["image_id"]], det)):
            raise SmokeFailure(f"PNG tree: {r['image_id']}'s resize is not the area resize's")
    import zlib

    data = encode_png(small[ids[0]], level=1, filters=(0, 1, 2, 3, 4))
    raw = zlib.decompress(data[data.index(b"IDAT") + 4:])  # one IDAT chunk
    t = time.perf_counter()
    plain = nb.png_unfilter_plain(raw, det[0], det[1])
    t_plain = time.perf_counter() - t
    if not np.array_equal(nb.png_unfilter_native(raw, det[0], det[1]), plain) or \
            not np.array_equal(plain, small[ids[0]]):
        raise SmokeFailure("the native PNG unfilter differs from its plain version")
    say(f"[pre] (g) PNG tree of {n} images at {size[0]}x{size[1]} (filters 0-4): written in "
        f"{t_write:.2f} s, read back bit-equal through DirectoryImageStore in "
        f"{1e3 * t_read / n:.1f} ms an image, its {det[0]}x{det[1]} resize equal to the area "
        f"resize; the native unfilter equal to the plain one ({1e3 * t_plain:.0f} ms plain at "
        f"{det[0]}x{det[1]})")
    out.update(png_write_s=t_write, png_read_ms=1e3 * t_read / n)
    return out


def preprocess_phase(seed, workdir):
    """Phase 13 on phase 7's run (``workdir``): the host steps, then (e)
    cli/pretrain on the port-written 1520x912 shards and (f) cli/detector on
    the 512x512 shards from ``best/``, (h) the phase's seconds."""
    import contextlib
    import io
    import tempfile

    import torch

    from mammo_clip_tpu_torch.cli import detector, pretrain
    from mammo_clip_tpu_torch.data import images
    from mammo_clip_tpu_torch.ops.mbconv import launches
    from mammo_clip_tpu_torch.train.checkpoint import load_checkpoint_arrays

    card = card_line()
    say(f"[pre] phase 13 on {card}")
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_pre_"))
    reads = []
    get0, make0 = images.PackedShardStore.get, detector.make_detector_steps

    def counted_get(self, study_id, image_id):
        reads.append(str(self.root))
        return get0(self, study_id, image_id)

    images.PackedShardStore.get = counted_get
    try:
        out = preprocess_host(seed, tmp)
        # (e) pretraining on the 1520x912 shards, full width
        del reads[:]
        launches.reset()
        t = time.perf_counter()
        state = pretrain.main(["--workdir", str(tmp / "run"), "--device", "cuda"]
                              + pretrain_overrides(tmp / "pretrain.csv", tmp / "shards", seed)
                              + ["scheduler.epochs=1"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        nf, nb_ = launches.total("mbconv6", "forward"), launches.total("mbconv6", "backward")
        rows = [json.loads(line) for line in (tmp / "run" / "metrics.jsonl").read_text()
                .splitlines()]
        train = [r for r in rows if r["prefix"] == "train"]
        losses = [r["loss/total"] for r in train]
        if state.step != STEPS or len(train) != STEPS:
            raise SmokeFailure(f"pretraining on shards: step {state.step}, {len(train)} train "
                               f"rows, expected {STEPS}")
        if not all(math.isfinite(r["loss/total"]) for r in rows):
            raise SmokeFailure("pretraining on shards: a loss is not finite")
        if (nf, nb_) != (14 * STEPS, 14 * STEPS):
            raise SmokeFailure(f"pretraining on shards: expected 14 forward and 14 backward "
                               f"fused calls per step, got {nf} and {nb_} in {STEPS}")
        if not reads or set(reads) != {str(tmp / "shards")}:
            raise SmokeFailure(f"pretraining did not read the port's shards: {set(reads)}")
        del state
        step_ms = [1e3 * BATCH / r["perf/images_per_sec"] for r in train]
        out["pretrain"] = dict(seconds=seconds, losses=losses, step_ms=step_ms,
                               fused=[nf, nb_], counts=dict(launches.counts),
                               shard_reads=len(reads))
        say(f"[pre] (e) cli/pretrain on the port's {PRE_SIZE[0]}x{PRE_SIZE[1]} shards (compat "
            f"B5, fused route and remat on, batch {BATCH}, 1 epoch): {seconds:.1f} s, step "
            f"{STEPS}, losses {[round(x, 6) for x in losses]}, per-step ms "
            f"{[round(m, 1) for m in step_ms]}, fused calls fwd {nf} bwd {nb_} "
            f"(14 + 14 a step; by form {dict(launches.counts)}), {len(reads)} shard reads")
        shutil.rmtree(tmp / "run", ignore_errors=True)

        # (f) detection on the 512x512 shards from phase 7's best/
        losses = []

        def instrumented(*a, **k):
            train_step, infer_step, infer_multiscale = make0(*a, **k)

            def step(*a_, **k_):
                res = train_step(*a_, **k_)
                losses.append({key: v.item() for key, v in res[1].items()})
                return res
            return step, infer_step, infer_multiscale

        detector.make_detector_steps = instrumented
        del reads[:]
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = detector.main(["--clip-checkpoint", str(workdir / "best"), "--csv",
                                 str(tmp / "det.csv"), "--image-dir", str(tmp / "shards_det"),
                                 "--resize", str(PRE_DET[0]), "--batch-size",
                                 str(PRE_DET_BATCH), "--epochs", "1", "--device", "cuda",
                                 "--workdir", str(tmp / "det")])
        seconds = time.perf_counter() - t
        n_valid = PRE_DET_BATCH
        arrays = load_checkpoint_arrays(str(tmp / "det" / "best"))
        if not (math.isfinite(res["best_mAP"]) and 0.0 <= res["best_mAP"] <= 1.0):
            raise SmokeFailure(f"detection on shards: best_mAP {res['best_mAP']}")
        if len(losses) != (PRE_IMAGES - n_valid) // PRE_DET_BATCH or not all(
                math.isfinite(v) for s_ in losses for v in s_.values()):
            raise SmokeFailure(f"detection on shards: train losses {losses}")
        if arrays["scores"].shape[0] != n_valid:
            raise SmokeFailure(f"detection on shards: {arrays['scores'].shape[0]} validation "
                               f"images scored, expected {n_valid}")
        if not reads or set(reads) != {str(tmp / "shards_det")}:
            raise SmokeFailure(f"detection did not read the port's shards: {set(reads)}")
        out["detector"] = dict(seconds=seconds, best_mAP=res["best_mAP"], losses=losses)
        say(f"[pre] (f) cli/detector on the port's {PRE_DET[0]}x{PRE_DET[1]} shards from "
            f"phase 7's best/ (batch {PRE_DET_BATCH}, 1 epoch): {seconds:.1f} s, best_mAP "
            f"{res['best_mAP']:.6f}, losses {[round(s_['total'], 5) for s_ in losses]}, "
            f"{arrays['scores'].shape[0]} validation images scored, {len(reads)} shard reads")
        out["seconds"] = time.perf_counter() - t_phase
        say(f"[pre] (h) phase 13: {out['seconds']:.1f} s on {card}; {host_cpu()}")
        return out
    finally:
        images.PackedShardStore.get = get0
        detector.make_detector_steps = make0
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 14: the flagship pretraining path
# --------------------------------------------------------------------------

FLAG_TIMED_CALLS = 2
FLAG_CLI_ROWS = 14  # 10 training rows (5 steps at BATCH), 4 validation rows (fold 0)
FLAG_ZS_ROWS = 16


def fused_total(launches):
    return launches.total("mbconv6", "forward") + launches.total("mbconv6", "backward")


def flagship_reference_check(seed):
    """(a) The tiny flagship CLIP (b0 at 64x48, in fp32): the same weights on the
    card and on the CPU, the eval embeddings, one train-mode forward and
    backward, one AdamW step and the loss after it. The update itself is
    printed, not gated: AdamW's first step moves each parameter by about the LR
    whatever the size of its gradient, so a gradient of rounding size (a bias
    feeding a BatchNorm) steps either way on the two sides."""
    import torch

    from mammo_clip_tpu_torch.core.config import tiny_test_config
    from mammo_clip_tpu_torch.losses import build_loss
    from mammo_clip_tpu_torch.models import build_model
    from mammo_clip_tpu_torch.ops.augment import minmax_standardize
    from mammo_clip_tpu_torch.ops.mbconv import launches
    from mammo_clip_tpu_torch.train import build_optimizer, create_train_state

    cfg = tiny_test_config()
    cfg.model.image_encoder.tpu_optimized = True
    cfg.data.image_size_w = 48
    cfg.model.image_encoder.drop_connect_rate = 0.0
    cfg.model.text_encoder.dropout_rate = 0.0
    cfg.model.projection_head.dropout = 0.0
    loss_fn = build_loss(cfg.loss.to_dict())
    res = {}
    for device in ("cuda", "cpu"):
        gen = torch.Generator(device="cpu").manual_seed(seed)
        model = build_model(cfg.model.to_dict(), device="cpu", generator=gen).to(device)
        batch = {k: v.to(device) for k, v in synthetic_batch(cfg, 4, seed, "cpu").items()}
        for k in ("images", "image_views"):
            batch[k] = minmax_standardize(batch[k], cfg.data.mean, cfg.data.std)
        n0 = fused_total(launches)
        with torch.no_grad():
            ev = model.embed_image(batch["images"], train=False).cpu()
        state = create_train_state(model, build_optimizer(cfg.optimizer.to_dict(),
                                                          lambda s: 1e-3,
                                                          model.named_parameters()))
        before = torch.cat([p.detach().flatten().cpu() for p in model.parameters()])
        out = model(batch, train=True)
        loss = loss_fn(out, batch, True)["total"]
        loss.backward()
        grads = torch.cat([p.grad.flatten().cpu() for p in model.parameters()])
        state.apply_gradients()
        update = torch.cat([p.detach().flatten().cpu() for p in model.parameters()]) - before
        with torch.no_grad():
            after = loss_fn(model(batch, train=True), batch, True)["total"].item()
        res[device] = dict(loss=loss.item(), emb=out["image_embeddings"].detach().cpu(), ev=ev,
                           grads=grads, update=update, after=after,
                           fused=fused_total(launches) - n0)
    c, h = res["cuda"], res["cpu"]
    err = dict(loss=abs(c["loss"] - h["loss"]) / max(1.0, abs(h["loss"])),
               emb=float((c["emb"] - h["emb"]).abs().max()),
               ev=float((c["ev"] - h["ev"]).abs().max()),
               grads=float((c["grads"] - h["grads"]).norm() / h["grads"].norm()),
               loss_after_step=abs(c["after"] - h["after"]) / max(1.0, abs(h["after"])))
    tol = dict(loss=1e-3, emb=1e-3, ev=1e-3, grads=1e-3, loss_after_step=1e-3)
    update = float((c["update"] - h["update"]).norm() / h["update"].norm())
    say(f"[flag] (a) tiny flagship CLIP (b0 at 64x48, fp32), card vs CPU: loss {c['loss']:.6f} "
        f"vs {h['loss']:.6f}, "
        + ", ".join(f"{k} {v:.2e} (tol {tol[k]:.0e})" for k, v in err.items())
        + f" (emb/ev: max|diff| of the train/eval embeddings; grads: relative norm); the "
          f"AdamW update's relative norm {update:.2e} (not gated: the first step moves a "
          f"parameter by ~LR whatever its gradient's size); fused launches "
          f"{c['fused']} / {h['fused']}")
    if any(err[k] > tol[k] for k in tol) or c["fused"] or h["fused"]:
        raise SmokeFailure("the tiny flagship on the card disagrees with the CPU")
    return dict(err, update=update)


def stacked_batches(cfg, n, k, seed):
    """k seeded synthetic batches of n samples on the card, stacked on a leading axis."""
    import torch

    batches = [synthetic_batch(cfg, n, seed + i, "cuda") for i in range(k)]
    return {key: torch.stack([b[key] for b in batches]) for key in batches[0]}


def flagship_bench(seed):
    """(b) the flagship bench step at full width, K steps a call, one warm-up call
    and FLAG_TIMED_CALLS timed; (c) the --trimmed recipe, one call timed."""
    import gc

    import torch

    from mammo_clip_tpu_torch.ops.mbconv import launches
    from mammo_clip_tpu_torch.train.recipes import (BENCH_BATCH, bench_recipe_config,
                                                    build_bench_train, default_steps_per_call)

    k = default_steps_per_call(compat=False)
    out = {}
    for arm, trimmed, calls in (("flagship", False, 1 + FLAG_TIMED_CALLS),
                                ("trimmed", True, 1)):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = bench_recipe_config(compat=False, trimmed=trimmed)
        ie = cfg.model.image_encoder
        t0 = time.perf_counter()
        model, _, state, _, step = build_bench_train(cfg, k_steps=k, device="cuda", seed=seed)
        batches = stacked_batches(cfg, BENCH_BATCH, k, seed + 10)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        say(f"[flag] ({'b' if arm == 'flagship' else 'c'}) {arm}: B5 tpu_optimized at "
            f"{cfg.data.image_size_h}x{cfg.data.image_size_w}, dense widths "
            f"{ie.get('tpu_dense_widths', True)}, slim "
            f"{ {s: ie.get(f'tpu_slim_stage{s}', 0) for s in (3, 4, 5, 6, 7)} }, remat "
            f"{ie.remat}, batch {BENCH_BATCH} (x2 views), K={k} steps a call, bf16, amp "
            f"attention scores {cfg.model.text_encoder.amp_attn_scores}: {n_params} params, "
            f"built in {time.perf_counter() - t0:.1f} s")
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        launches.reset()
        torch.cuda.reset_peak_memory_stats()
        rows = []
        try:
            for i in range(calls):
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, loss = step(state, batches, gen)
                total = float(loss["total"])
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3
                rows.append(dict(call=i, loss=total, ms=ms, ms_per_step=ms / k))
                say(f"[flag] {arm} call {i}{' (warm-up)' if arm == 'flagship' and i == 0 else ''}"
                    f": {k} steps in {ms:.1f} ms ({ms / k:.1f} ms a step), last loss {total:.6f}")
                if not math.isfinite(total):
                    raise SmokeFailure(f"{arm} call {i}: loss is not finite")
        except torch.cuda.OutOfMemoryError as e:
            raise SmokeFailure(f"the {arm} step at batch {BENCH_BATCH} does not fit the card "
                               f"({torch.cuda.max_memory_allocated()} B allocated at the peak): "
                               f"{e}") from None
        peak = torch.cuda.max_memory_allocated()
        fused = dict(launches.counts)
        if state.step != k * calls or any(fused.values()):
            raise SmokeFailure(f"{arm}: step {state.step}, fused launches {fused}")
        timed = rows[1:] if arm == "flagship" else rows
        step_ms = [r["ms_per_step"] for r in timed]
        per_s = 1e3 * 2 * BENCH_BATCH * len(step_ms) / sum(step_ms)
        out[arm] = dict(calls=rows, step_ms=step_ms, images_per_s=per_s, peak_bytes=peak,
                        fused=fused, params=n_params)
        say(f"[flag] {arm}: ms a step {[round(m, 1) for m in step_ms]} "
            f"({'calls after the warm-up' if arm == 'flagship' else 'the first call'}), "
            f"{per_s:.2f} images/s ({2 * BENCH_BATCH} views a step), peak memory {peak} B "
            f"({peak / 2**30:.2f} GiB), fused launches {fused or 0}")
        del model, state, step, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def flagship_overrides(csv_path, seed):
    """cli/pretrain's overrides that make the default B5 config the flagship
    recipe (``bench_recipe_config(compat=False)``) at batch BATCH, K steps a call,
    and temper the warm-started peak LR."""
    from mammo_clip_tpu_torch.train.recipes import default_steps_per_call

    entry = json.dumps([{"csv": str(csv_path), "image_dir": "synthetic://",
                         "data_type": "imagetext"}])
    return ["model.image_encoder.tpu_optimized=true", "model.image_encoder.remat=false",
            "model.text_encoder.amp_attn_scores=true",
            f"train.steps_per_call={default_steps_per_call(compat=False)}",
            "optimizer.warm_start_lr_scale=0.25", f"data.train={entry}", f"data.valid={entry}",
            f"data.batch_size_per_device={BATCH}", "scheduler.warmup_epochs=0",
            "train.log_every=1", f"seed={seed}"]


def flagship_cli(seed, workdir, tmp):
    """(d) cli/pretrain with the flagship overrides, warm-started from phase 7's
    best/: 1 epoch of K steps, then --resume for a second; the seeded tensors
    checked against ``warm_start_state_dict`` of that checkpoint."""
    import torch

    from mammo_clip_tpu_torch.cli import pretrain
    from mammo_clip_tpu_torch.convert.flagship_init import warm_start_state_dict
    from mammo_clip_tpu_torch.eval.loading import load_clip_for_eval
    from mammo_clip_tpu_torch.ops.mbconv import launches
    from mammo_clip_tpu_torch.train import trainer as trainer_mod
    from mammo_clip_tpu_torch.train.recipes import bench_recipe_config, default_steps_per_call

    k = default_steps_per_call(compat=False)
    source = str(workdir / "best")
    seeds, peaks = [], []
    warm0, build0 = trainer_mod.Trainer.warm_start, trainer_mod.Trainer._build_state

    def built(self, steps_per_epoch, lr_scale=1.0):
        state = build0(self, steps_per_epoch, lr_scale=lr_scale)
        peaks.append((lr_scale, float(self._schedule(0))))
        return state

    def recorded(self, state, src):
        before = {n: t.detach().cpu().clone() for n, t in self.model.state_dict().items()}
        t = time.perf_counter()
        state, names = warm0(self, state, src)
        seconds = time.perf_counter() - t
        after = {n: t_.detach().cpu().clone() for n, t_ in self.model.state_dict().items()}
        seeds.append(dict(before=before, after=after, names=names, seconds=seconds))
        return state, names

    trainer_mod.Trainer.warm_start, trainer_mod.Trainer._build_state = recorded, built
    try:
        csv_path = tmp / "flag.csv"
        write_pretrain_csv(csv_path, FLAG_CLI_ROWS)
        run = tmp / "flag"
        flags = ["--workdir", str(run), "--device", "cuda", "--warm-start-from", source]
        overrides = flagship_overrides(csv_path, seed)
        launches.reset()
        runs = []
        for epochs in (1, 2):
            t = time.perf_counter()
            state = pretrain.main(flags + (["--resume"] if epochs == 2 else []) + overrides
                                  + [f"scheduler.epochs={epochs}"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
            runs.append(dict(epochs=epochs, seconds=seconds, step=state.step))
            say(f"[flag] (d) cli/pretrain flagship run {epochs}: {seconds:.1f} s, step "
                f"{state.step}, warm start {seeds[-1]['seconds']:.1f} s")
            if state.step != k * epochs:
                raise SmokeFailure(f"flagship cli run {epochs}: step {state.step}, expected "
                                   f"{k * epochs}")
            if not hasattr(state.model.image_encoder, "tpu_stem_conv"):
                raise SmokeFailure("the flagship cli did not build the flagship encoder")
            del state
        if fused_total(launches):
            raise SmokeFailure(f"fused launches on the flagship path: {launches.counts}")

        # the seeded tensors are warm_start_state_dict of the source checkpoint
        first = seeds[0]
        src, _ = load_clip_for_eval(source, device="cpu")
        src_state = src.state_dict()
        del src
        want = warm_start_state_dict(src_state, first["before"])
        bad = [n for n in want if not torch.equal(first["after"][n].float(), want[n])]
        kept = [n for n in first["after"] if n not in first["names"]]
        changed_kept = [n for n in kept if not torch.equal(first["after"][n],
                                                           first["before"][n])]
        if bad or changed_kept or "logit_scale" not in first["names"] or \
                not torch.equal(first["after"]["logit_scale"].float(), src_state["logit_scale"]):
            raise SmokeFailure(f"warm start: {len(bad)} tensors differ from "
                               f"warm_start_state_dict ({bad[:3]}), {len(changed_kept)} "
                               f"unseeded tensors changed ({changed_kept[:3]})")
        front = sorted({n.split(".")[1] for n in kept if n.startswith("image_encoder.tpu_")})
        say(f"[flag] (d) warm start from phase 7's best/: {len(first['names'])} of "
            f"{len(first['after'])} tensors seeded, {len(kept)} kept fresh ({front}); each "
            f"equal to warm_start_state_dict of the checkpoint, logit_scale "
            f"{float(src_state['logit_scale']):.6f} carried")

        cfg = json.loads((run / "config.json").read_text())
        ref = bench_recipe_config(compat=False).to_dict()
        ref["optimizer"]["warm_start_lr_scale"] = 0.25
        for key in ("model", "loss", "optimizer", "augment"):
            if cfg[key] != ref[key]:
                raise SmokeFailure(f"flagship cli config.{key} is not the flagship recipe's")
        rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
        train = [r for r in rows if r["prefix"] == "train"]
        valid = [r for r in rows if r["prefix"] == "valid"]
        if [r["step"] for r in train] != [k, 2 * k] or len(valid) != 2:
            raise SmokeFailure(f"flagship metrics: train steps {[r['step'] for r in train]}, "
                               f"{len(valid)} validation rows")
        if not all(math.isfinite(r["loss/total"]) for r in train + valid):
            raise SmokeFailure("flagship cli: a loss is not finite")
        want_peak = 0.25 * ref["optimizer"]["lr"]
        if [p[0] for p in peaks] != [0.25, 0.25] or \
                any(abs(p[1] - want_peak) > 1e-6 * want_peak for p in peaks):
            raise SmokeFailure(f"flagship cli: LR scale and peak {peaks}, expected 0.25 and "
                               f"{want_peak}")
        step_ms = [1e3 * BATCH / r["perf/images_per_sec"] for r in train]
        for step_dir in (run / "checkpoints" / str(k), run / "checkpoints" / str(2 * k)):
            if not (step_dir / "state.pt").exists():
                raise SmokeFailure(f"flagship cli wrote no {step_dir}")
        best = [d.name for d in (run / "best").iterdir()]
        say(f"[flag] (d) losses {[round(r['loss/total'], 6) for r in train]} (each call's "
            f"last), validation {[round(r['loss/total'], 6) for r in valid]}, peak LR "
            f"{peaks[0][1]} ({ref['optimizer']['lr']} x 0.25), ms a step by call (host clock, "
            f"data wait included) {[round(m, 1) for m in step_ms]}, best/ at step {best}, "
            f"fused launches 0")
        return dict(runs=runs, seeded=len(first["names"]), kept=len(kept),
                    warm_start_s=[s["seconds"] for s in seeds], step_ms=step_ms,
                    seconds=sum(r["seconds"] for r in runs)), run
    finally:
        trainer_mod.Trainer.warm_start, trainer_mod.Trainer._build_state = warm0, build0


def flagship_serving(run, tmp):
    """(e) cli/zeroshot and cli/detector (512x512, 1 epoch) on (d)'s best/."""
    import contextlib
    import io

    import torch

    from mammo_clip_tpu_torch.cli import detector, zeroshot
    from mammo_clip_tpu_torch.ops.mbconv import launches

    best = str(run / "best")
    out = {}
    launches.reset()
    t = time.perf_counter()
    zs = zeroshot.main(["--checkpoint", best, "--csv",
                        str(write_zeroshot_csv(tmp / "zs.csv", FLAG_ZS_ROWS)),
                        "--image-dir", "synthetic://", "--batch-size", str(SERVE_BATCH),
                        "--device", "cuda"])
    out["zeroshot"], out["zeroshot_s"] = zs, time.perf_counter() - t
    if set(zs) != {"mass", "suspicious_calcification"} or \
            not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in zs.values()):
        raise SmokeFailure(f"zero-shot on the flagship best/: {zs}")
    say(f"[flag] (e) cli/zeroshot on the flagship best/ ({FLAG_ZS_ROWS} rows at 1520x912): "
        f"AUROC {zs}, {out['zeroshot_s']:.1f} s")

    widths = []
    build0 = detector.retinanet_from_clip_checkpoint

    def build(*a, **k):
        model = build0(*a, **k)
        widths.append([model.fpn.p3_lateral.kernel.shape[1],
                       model.fpn.p4_lateral.kernel.shape[1],
                       model.fpn.p5_lateral.kernel.shape[1]])
        return model

    detector.retinanet_from_clip_checkpoint = build
    try:
        write_detection_csv(tmp / "det.csv")
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = detector.main(["--clip-checkpoint", best, "--csv", str(tmp / "det.csv"),
                                 "--image-dir", "synthetic://", "--resize", str(DET_SIZE),
                                 "--batch-size", str(DET_BATCH), "--epochs", "1",
                                 "--device", "cuda", "--workdir", str(tmp / "det")])
        torch.cuda.synchronize()
        out["detector"], out["detector_s"] = res, time.perf_counter() - t
    finally:
        detector.retinanet_from_clip_checkpoint = build0
    if widths != [[128, 512, 2048]]:
        raise SmokeFailure(f"the detector's FPN over the flagship took widths {widths}, "
                           f"expected [[128, 512, 2048]]")
    if not (math.isfinite(res["best_mAP"]) and 0.0 <= res["best_mAP"] <= 1.0):
        raise SmokeFailure(f"cli/detector on the flagship best/: {res}")
    if fused_total(launches):
        raise SmokeFailure(f"fused launches in (e): {launches.counts}")
    say(f"[flag] (e) cli/detector on the flagship best/ ({DET_SIZE}x{DET_SIZE}, batch "
        f"{DET_BATCH}, 1 epoch): best_mAP {res['best_mAP']:.6f}, FPN input widths "
        f"{widths[0]} (C3, C4, C5), {out['detector_s']:.1f} s, fused launches 0")
    return out


def flagship_phase(seed, workdir):
    """Phase 14 on phase 7's run (``workdir``), whose directory is kept until this
    phase ends: (a) the tiny flagship card vs CPU, (b) the flagship bench step,
    (c) the trimmed recipe, (d) cli/pretrain warm-started from phase 7's best/,
    (e) cli/zeroshot and cli/detector on (d)'s best/, (f) the phase's seconds."""
    import tempfile

    card = card_line()
    say(f"[flag] phase 14 on {card}")
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_flag_"))
    try:
        out = {"reference": flagship_reference_check(seed)}
        out.update(flagship_bench(seed))
        out["cli"], run = flagship_cli(seed, workdir, tmp)
        out["serving"] = flagship_serving(run, tmp)
        out["seconds"] = time.perf_counter() - t_phase
        fl, tr = out["flagship"], out["trimmed"]
        say(f"[flag] (f) phase 14: {out['seconds']:.1f} s on {card}; flagship "
            f"{sum(fl['step_ms']) / len(fl['step_ms']):.1f} ms a step, "
            f"{fl['images_per_s']:.2f} images/s, peak {fl['peak_bytes'] / 2**30:.2f} GiB; "
            f"trimmed {sum(tr['step_ms']) / len(tr['step_ms']):.1f} ms a step (first call); "
            f"cli/pretrain warm-started {out['cli']['seconds']:.1f} s")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 15: the other encoder families and Mammo-FActOR
# --------------------------------------------------------------------------

VIT_FLASH_SHAPE = (BATCH, 12, 95 * 57 + 1, 64)  # ViT-B/16's attention at 1520x912
FAMILY_CELLS = (("vit", "vit-base", 1520, 912), ("swin", "swin-tiny", 1536, 1024),
                ("resnet", "resnet101", 1520, 912))
FAMILY_TIMED_STEPS = 5
TINY_FAMILIES = {
    "vit": {"name": "vit-tiny", "patch_size": 8, "hidden_size": 32, "num_layers": 2,
            "num_heads": 2, "mlp_dim": 64, "base_grid": 4},
    "swin": {"name": "swin-tiny", "patch_size": 4, "embed_dim": 16, "depths": [2, 2],
             "num_heads": [2, 2], "window": 4},
    "resnet": {"name": "resnet50"},
}
# card vs CPU, relative norm of the whole step's gradient. ResNet-50's train
# step at random init is ill-conditioned: a rounding-level change of a ReLU's
# or the max pool's input can flip its decision, each train-mode BatchNorm
# spreads the flip over its channel, and 17 BatchNorm'd units amplify it
# further, so the whole-step gradient moves by a few percent under a 1e-6
# relative change of the images (which (b) measures on the CPU and prints),
# whatever the input size. So that gate catches only a gross fault, and
# ResNet-50's gradients are held at RESNET_PAIR_TOL pair by pair instead
# (resnet_pair_check): each conv + BatchNorm pair is smooth and gets the same
# input on both sides.
FAMILY_GRAD_TOL = {"vit": 1e-3, "swin": 1e-3, "resnet": 5e-2}
RESNET_PAIR_TOL = 1e-3
RESNET_PERTURB = 1e-6
VIT_CLI_ROWS = 6  # 4 training rows (2 steps at BATCH), 2 validation rows (fold 0)
FACTOR_POS_ROWS = 16
FACTOR_BATCH = 8


def flash_counts():
    from mammo_clip_tpu_torch.ops.flash_attention import launches

    return [launches.counts["flash_attention.forward"], launches.counts["flash_attention.backward"]]


def vit_flash_check(seed):
    """(a) The flash kernel at the ViT-B/16 step's attention shape against its
    plain version (fp32 and bf16, out and gradients, phase 8's tolerances), and
    its times beside the plain version's, SDPA's and the bound."""
    import torch

    shape = VIT_FLASH_SHAPE
    errs = {dt: check_flash(shape, dt, seed, yardstick=dt == "bfloat16")
            for dt in ("float32", "bfloat16")}
    times, device, bounds = flash_timing(*flash_inputs(shape, torch.bfloat16, seed))
    for i, what in enumerate(("forward", "backward", "forward+backward")):
        say(f"[fam] (a) flash {shape} bf16 {what}, ms (CUDA events | device time): "
            + ", ".join(f"{name} {times[name][i]:.4f} | {device[name][i]:.4f}"
                        for name in ("kernel", "plain", "einsum", "sdpa"))
            + f"; bound {bounds[i][0]:.4f} ms ({bounds[i][1]}: 4 B N S^2 D products at "
              f"{BF16_FLOPS / 1e12:.0f} TFLOP/s against the bytes at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); kernel at "
              f"{100 * bounds[i][0] / device['kernel'][i]:.1f}% of its bound")
    return dict(err=errs["bfloat16"], err_fp32=errs["float32"], times=times, device=device,
                bounds=bounds)


RESNET_PAIRS = {"stem_conv": "stem_bn", "conv1": "bn1", "conv2": "bn2", "conv3": "bn3",
                "downsample": "downsample_bn"}


def resnet_pair_check(state, cfg, images, seed):
    """(b) Each of ResNet-50's 53 conv + train-mode BatchNorm pairs on the CPU's
    own input to it (captured in one CPU train-mode forward), on both devices,
    with one seeded cotangent: the relative norm of the output, the input's
    gradient and the pair's parameter gradients, the worst pair of each. The
    pair is smooth: no ReLU or max-pool decision lies inside it."""
    import torch

    from mammo_clip_tpu_torch.models import build_model

    encs = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg.model.to_dict(), device="cpu")
        model.load_state_dict(state)
        encs[device] = model.image_encoder.to(device)
    ref = encs["cpu"]
    inputs, hooks = {}, []
    for name, mod in ref.named_modules():
        if name.rsplit(".", 1)[-1] in RESNET_PAIRS:
            hooks.append(mod.register_forward_pre_hook(
                lambda mod, args, name=name: inputs.setdefault(name, args[0].detach().cpu())))
    with torch.no_grad():
        ref(images.cpu(), train=True)
    for h in hooks:
        h.remove()
    g = torch.Generator().manual_seed(seed)
    worst = {}
    for name, x in inputs.items():
        parent, _, conv_name = name.rpartition(".")
        res, cot = {}, None
        for device, enc in encs.items():
            owner = enc.get_submodule(parent) if parent else enc
            conv, bn = getattr(owner, conv_name), getattr(owner, RESNET_PAIRS[conv_name])
            xi = x.to(device, copy=True).requires_grad_()
            z = bn(conv(xi), True)[0]
            if cot is None:
                cot = torch.randn(z.shape, generator=g)
            (z * cot.to(device)).sum().backward()
            res[device] = dict(y=z.detach().cpu(), dx=xi.grad.cpu(), dp=torch.cat(
                [p.grad.flatten().cpu() for m in (conv, bn) for p in m.parameters()]))
            enc.zero_grad(set_to_none=True)
        a, b = res["cuda"], res["cpu"]
        for k in a:
            err = float((a[k] - b[k]).norm() / b[k].norm())
            if err >= worst.get(k, (0.0, ""))[0]:
                worst[k] = (err, name)
    return worst


def family_reference_check(seed):
    """(b) A tiny CLIP of each family (ViT, Swin, ResNet-50; b0-sized BERT, 64x64)
    on the card and on the CPU from one state dict, fp32 with TF32 off: eval
    embeddings and one train-mode forward and backward (loss, gradients); for
    ResNet-50 also the CPU step's gradient under a RESNET_PERTURB change of the
    images, and its gradients pair by pair (resnet_pair_check)."""
    import torch

    from mammo_clip_tpu_torch.core.config import tiny_test_config
    from mammo_clip_tpu_torch.losses import build_loss
    from mammo_clip_tpu_torch.models import build_model
    from mammo_clip_tpu_torch.ops.augment import minmax_standardize

    out = {}
    for fam, enc in TINY_FAMILIES.items():
        cfg = tiny_test_config()
        cfg.model.image_encoder = dict(enc)
        cfg.model.text_encoder.dropout_rate = 0.0
        loss_fn = build_loss(cfg.loss.to_dict())
        state = build_model(cfg.model.to_dict(), device="cpu",
                            generator=torch.Generator().manual_seed(seed)).state_dict()
        res = {}
        runs = [("cuda", 0.0), ("cpu", 0.0)] + ([("cpu", RESNET_PERTURB)] if fam == "resnet" else [])
        for device, perturb in runs:
            model = build_model(cfg.model.to_dict(), device="cpu")
            model.load_state_dict(state)
            model = model.to(device)
            batch = {k: v.to(device) for k, v in synthetic_batch(cfg, 4, seed, "cpu").items()}
            noise = torch.Generator().manual_seed(seed + 1)
            for k in ("images", "image_views"):
                batch[k] = minmax_standardize(batch[k], cfg.data.mean, cfg.data.std)
                if perturb:
                    batch[k] = batch[k] * (1 + perturb * torch.randn(batch[k].shape,
                                                                     generator=noise))
            n0 = flash_counts()
            with torch.no_grad():
                ev = model.embed_image(batch["images"], train=False).cpu()
            loss = loss_fn(model(batch, train=True), batch, True)["total"]
            loss.backward()
            grads = torch.cat([p.grad.flatten().cpu() for p in model.parameters()])
            res[device if not perturb else "perturbed"] = dict(
                loss=loss.item(), ev=ev, grads=grads, images=batch["images"],
                flash=[a - b for a, b in zip(flash_counts(), n0)])
        c, h = res["cuda"], res["cpu"]
        rel_grads = lambda r: float((r["grads"] - h["grads"]).norm() / h["grads"].norm())
        err = dict(loss=abs(c["loss"] - h["loss"]) / max(1.0, abs(h["loss"])),
                   ev=float((c["ev"] - h["ev"]).abs().max()), grads=rel_grads(c))
        tol = dict(loss=1e-3, ev=1e-3, grads=FAMILY_GRAD_TOL[fam])
        want_flash = [6, 4] if fam == "vit" else [0, 0]  # eval 1 + train 2 tower passes
        say(f"[fam] (b) tiny {fam} CLIP (64x64, fp32), card vs CPU: loss {c['loss']:.6f} vs "
            f"{h['loss']:.6f}, " + ", ".join(f"{k} {v:.2e} (tol {tol[k]:.0e})"
                                             for k, v in err.items())
            + f" (ev: max|diff| of the eval embeddings; grads: relative norm); flash "
              f"launches fwd/bwd {c['flash']} on the card, {h['flash']} on the CPU")
        bad = any(err[k] > tol[k] for k in tol) or c["flash"] != want_flash or any(h["flash"])
        if fam == "resnet":
            err["grads_cpu_perturbed"] = rel_grads(res["perturbed"])
            pairs = resnet_pair_check(state, cfg, h["images"], seed)
            err.update({f"pair_{k}": v[0] for k, v in pairs.items()})
            say(f"[fam] (b) tiny resnet: the CPU step's gradient under a {RESNET_PERTURB:.0e} "
                f"relative change of the images moves by {err['grads_cpu_perturbed']:.2e} "
                f"(relative norm); its 53 conv + train-mode BatchNorm pairs one by one (the "
                f"CPU's input to each on both sides), card vs CPU, worst pair: "
                + ", ".join(f"{k} {v[0]:.2e} ({v[1]})" for k, v in pairs.items())
                + f" (tol {RESNET_PAIR_TOL:.0e}; y: output, dx: input gradient, dp: "
                  f"parameter gradients, relative norms)")
            bad = bad or any(v[0] > RESNET_PAIR_TOL for v in pairs.values())
        if bad:
            raise SmokeFailure(f"the tiny {fam} CLIP on the card disagrees with the CPU")
        out[fam] = err
    return out


def family_steps(seed):
    """(c) ``bench_recipe_config(compat=True)`` (remat and fused_mbconv set, which
    only EfficientNet reads) with each family's image encoder at full width,
    BERT-base, batch BATCH: one warm-up step and FAMILY_TIMED_STEPS timed (host
    clock, ending in a synchronise), peak memory, the counters read around the
    run: 24 + 24 flash calls a ViT step (12 layers, two tower passes), no fused
    MBConv call."""
    import gc

    import torch

    from mammo_clip_tpu_torch.ops import flash_attention
    from mammo_clip_tpu_torch.ops.mbconv import launches as fused
    from mammo_clip_tpu_torch.train.recipes import bench_recipe_config, build_bench_train

    out = {}
    for fam, name, h, w in FAMILY_CELLS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = bench_recipe_config(compat=True)
        cfg.model.image_encoder.name = name
        cfg.data.image_size_h, cfg.data.image_size_w = h, w
        t0 = time.perf_counter()
        model, _, state, _, step = build_bench_train(cfg, device="cuda", seed=seed)
        batch = synthetic_batch(cfg, BATCH, seed, "cuda")
        torch.cuda.synchronize()
        enc = model.image_encoder
        n_enc = sum(p.numel() for p in enc.parameters())
        say(f"[fam] (c) {name} ({type(enc).__name__}, out_dim {enc.out_dim}, {n_enc} params) + "
            f"BERT-base at {h}x{w}, batch {BATCH} (x2 views), bf16: built in "
            f"{time.perf_counter() - t0:.1f} s")
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        flash_attention.launches.reset()
        fused.reset()
        rows = []
        try:
            for i in range(1 + FAMILY_TIMED_STEPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, loss = step(state, batch, gen)
                total = float(loss["total"])
                torch.cuda.synchronize()
                rows.append(dict(loss=total, ms=(time.perf_counter() - t) * 1e3))
                if not math.isfinite(total):
                    raise SmokeFailure(f"{name} step {i}: loss is not finite")
        except torch.cuda.OutOfMemoryError as e:
            raise SmokeFailure(f"the {name} step at batch {BATCH} does not fit the card: "
                               f"{e}") from None
        flash = flash_counts()
        n_fused = fused.total("mbconv6", "forward") + fused.total("mbconv6", "backward")
        peak = torch.cuda.max_memory_allocated()
        want = [24 * len(rows)] * 2 if fam == "vit" else [0, 0]
        step_ms = [r["ms"] for r in rows[1:]]
        per_s = 1e3 * 2 * BATCH * len(step_ms) / sum(step_ms)
        say(f"[fam] (c) {name}: losses {[round(r['loss'], 6) for r in rows]}, ms a step "
            f"{[round(m, 1) for m in step_ms]} (median {sorted(step_ms)[len(step_ms) // 2]:.1f})"
            f" after a warm-up of {rows[0]['ms']:.1f}, "
            f"{per_s:.2f} images/s, peak memory {peak} B ({peak / 2**30:.2f} GiB), flash "
            f"launches fwd/bwd {flash} (expected {want}), fused MBConv launches {n_fused}")
        if flash != want or n_fused:
            raise SmokeFailure(f"{name}: flash launches {flash}, expected {want}; fused "
                               f"MBConv launches {n_fused}")
        out[fam] = dict(name=name, hw=[h, w], step_ms=step_ms, warmup_ms=rows[0]["ms"],
                        images_per_s=per_s, peak_bytes=peak, flash=flash,
                        encoder_params=n_enc, losses=[r["loss"] for r in rows])
        del model, state, step, batch, enc
    gc.collect()
    torch.cuda.empty_cache()
    return out


def vit_cli(seed, tmp):
    """(d) cli/pretrain with ``model.image_encoder.name=vit-base`` (the compat
    recipe's overrides otherwise), 1 epoch of 2 steps, then ``--resume`` to 2;
    cli/zeroshot and cli/classifier ``--arch lp`` (1 epoch) on its best/. The
    flash counters read around each: both directions in training, forward
    alone in the evaluation paths."""
    import contextlib
    import io

    import torch

    from mammo_clip_tpu_torch.cli import classifier, pretrain, zeroshot
    from mammo_clip_tpu_torch.models import ViT

    csv_path = tmp / "vit_pretrain.csv"
    write_pretrain_csv(csv_path, VIT_CLI_ROWS)
    run = tmp / "vit"
    flags = ["--workdir", str(run), "--device", "cuda"]
    overrides = pretrain_overrides(csv_path, "synthetic://", seed) + [
        "model.image_encoder.name=vit-base"]
    out = {"runs": []}
    for epochs in (1, 2):
        n0 = flash_counts()
        t = time.perf_counter()
        state = pretrain.main(flags + (["--resume"] if epochs == 2 else []) + overrides
                              + [f"scheduler.epochs={epochs}"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        flash = [a - b for a, b in zip(flash_counts(), n0)]
        say(f"[fam] (d) cli/pretrain vit-base run {epochs}: {seconds:.1f} s, step {state.step}, "
            f"flash launches fwd/bwd {flash}")
        if state.step != 2 * epochs or not isinstance(state.model.image_encoder, ViT):
            raise SmokeFailure(f"vit cli run {epochs}: step {state.step}, encoder "
                               f"{type(state.model.image_encoder).__name__}")
        if min(flash) < 24 * 2:
            raise SmokeFailure(f"vit cli run {epochs}: flash launches {flash}")
        out["runs"].append(dict(seconds=seconds, flash=flash))
        del state
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss/total"] for r in rows if r["prefix"] in ("train", "valid")]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise SmokeFailure(f"vit cli losses {losses}")
    best = str(run / "best")

    n0 = flash_counts()
    t = time.perf_counter()
    zs = zeroshot.main(["--checkpoint", best, "--csv",
                        str(write_zeroshot_csv(tmp / "vit_zs.csv", FLAG_ZS_ROWS)),
                        "--image-dir", "synthetic://", "--batch-size", str(SERVE_BATCH),
                        "--device", "cuda"])
    zs_s, zs_flash = time.perf_counter() - t, [a - b for a, b in zip(flash_counts(), n0)]
    if set(zs) != {"mass", "suspicious_calcification"} or \
            not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in zs.values()):
        raise SmokeFailure(f"zero-shot on the vit best/: {zs}")
    say(f"[fam] (d) cli/zeroshot on the vit best/ ({FLAG_ZS_ROWS} rows at 1520x912): AUROC "
        f"{zs}, {zs_s:.1f} s, flash launches fwd/bwd {zs_flash}")

    write_classifier_csv(tmp / "vit_clf.csv")
    n0 = flash_counts()
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        clf = classifier.main(["--clip-checkpoint", best, "--csv", str(tmp / "vit_clf.csv"),
                               "--image-dir", "synthetic://", "--arch", "lp", "--epochs", "1",
                               "--batch-size", str(CLF_BATCH), "--device", "cuda",
                               "--workdir", str(tmp / "vit_clf")])
    clf_s, clf_flash = time.perf_counter() - t, [a - b for a, b in zip(flash_counts(), n0)]
    if not (math.isfinite(clf["best_metric"]) and 0.0 <= clf["best_metric"] <= 1.0):
        raise SmokeFailure(f"cli/classifier lp on the vit best/: {clf}")
    say(f"[fam] (d) cli/classifier --arch lp on the vit best/ ({CLF_TRAIN_ROWS} + "
        f"{CLF_VALID_ROWS} rows at 1520x912, batch {CLF_BATCH}, 1 epoch, fp32): best_metric "
        f"{clf['best_metric']:.6f}, {clf_s:.1f} s, flash launches fwd/bwd {clf_flash}")
    for what, flash in (("zeroshot", zs_flash), ("classifier lp", clf_flash)):
        if flash[0] < 12 or flash[1]:
            raise SmokeFailure(f"vit {what}: flash launches {flash}, expected forward only")
    out.update(zeroshot=zs, zeroshot_s=zs_s, classifier=clf["best_metric"], classifier_s=clf_s,
               losses=losses)
    return out


def write_factor_csv(path, n_pos):
    """n_pos VinDr-style training rows positive for Mass, calcification or both
    (fold 1), 4 negative training rows (the CLI drops them) and 2 validation
    rows (fold 0)."""
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["patient_id", "image_id", "Mass", "Suspicious_Calcification", "fold"])
        for i in range(n_pos):
            w.writerow([f"f{i}", f"f{i}.png", int(i % 3 != 1), int(i % 3 != 0), 1])
        for i in range(4):
            w.writerow([f"n{i}", f"n{i}.png", 0, 0, 1])
        for i in range(2):
            w.writerow([f"v{i}", f"v{i}.png", 1, 0, 0])
    return path


def factor_phase(workdir, tmp):
    """(e) cli/factor on phase 7's B5 best/ at 1520x912: both attributes,
    FACTOR_POS_ROWS positive rows, batch FACTOR_BATCH, 2 epochs; the mapper
    reads the (B, 48, 29, 2048) features as 2048 regions of 1392 positions."""
    import contextlib
    import io

    import torch

    from mammo_clip_tpu_torch.cli import factor
    from mammo_clip_tpu_torch.ops.mbconv import launches as fused
    from mammo_clip_tpu_torch.train.checkpoint import latest_step

    csv_path = write_factor_csv(tmp / "factor.csv", FACTOR_POS_ROWS)
    fused.reset()
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = factor.main(["--clip-checkpoint", str(workdir / "best"), "--csv", str(csv_path),
                           "--image-dir", "synthetic://", "--epochs", "2", "--batch-size",
                           str(FACTOR_BATCH), "--device", "cuda",
                           "--workdir", str(tmp / "factor")])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    mapper = tmp / "factor" / "mapper"
    step = latest_step(str(mapper))
    steps = 2 * (FACTOR_POS_ROWS // FACTOR_BATCH)
    payload = torch.load(mapper / str(step) / "state.pt", map_location="cpu", weights_only=True)
    fc1 = tuple(payload["model"]["proj0_fc1.kernel"].shape)
    n_fused = fused.total("mbconv6", "forward") + fused.total("mbconv6", "backward")
    epochs = [line for line in buf.getvalue().splitlines() if line.startswith("epoch ")]
    say(f"[fam] (e) cli/factor on phase 7's B5 best/ (1520x912, {FACTOR_POS_ROWS} positive "
        f"rows, batch {FACTOR_BATCH}, 2 epochs): {epochs}, final_loss {res['final_loss']:.6f}, "
        f"mapper saved at step {step} (proj0_fc1 {fc1}: 48 x 29 = 1392 positions), "
        f"{seconds:.1f} s, fused MBConv launches {n_fused}")
    if not math.isfinite(res["final_loss"]) or step != steps or fc1 != (1392, 1392) or n_fused:
        raise SmokeFailure(f"cli/factor: {res}, step {step} (expected {steps}), fc1 {fc1}, "
                           f"fused launches {n_fused}")
    return dict(final_loss=res["final_loss"], seconds=seconds, step=step)


def _split_patch(kernel):
    """A 1-channel patch kernel as 3 channels [k/2, k/2, 0], which the HF
    importers sum back to k exactly (halving is exact in binary)."""
    import torch

    return torch.cat([kernel / 2, kernel / 2, torch.zeros_like(kernel)], dim=1)


def _hf_block(sd, src, b, d):
    """An HF ViT/Swin layer's LayerNorm, output and MLP tensors from a port block."""
    sd[src + "layernorm_before.weight"], sd[src + "layernorm_before.bias"] = b.ln1.scale, b.ln1.bias
    sd[src + "layernorm_after.weight"], sd[src + "layernorm_after.bias"] = b.ln2.scale, b.ln2.bias
    sd[src + "intermediate.dense.weight"] = b.fc1.kernel.t()
    sd[src + "intermediate.dense.bias"] = b.fc1.bias
    sd[src + "output.dense.weight"], sd[src + "output.dense.bias"] = b.fc2.kernel.t(), b.fc2.bias
    proj = b.attn.out if hasattr(b, "attn") else b.proj
    sd[src + "attention.output.dense.weight"] = proj.kernel.reshape(d, d).t()
    sd[src + "attention.output.dense.bias"] = proj.bias


def hf_vit_state_dict(m):
    """A port ViT's tensors under HF ``ViTModel``'s names (the inverse of
    ``convert_hf_vit``), on the tensors' own device."""
    d = m.cfg.hidden_size
    sd = {"embeddings.cls_token": m.cls_token, "embeddings.position_embeddings": m.pos_embedding,
          "embeddings.patch_embeddings.projection.weight": _split_patch(m.patch_embed.kernel),
          "embeddings.patch_embeddings.projection.bias": m.patch_embed.bias,
          "layernorm.weight": m.ln_final.scale, "layernorm.bias": m.ln_final.bias}
    for i in range(m.cfg.num_layers):
        b, src = getattr(m, f"block_{i}"), f"encoder.layer.{i}."
        _hf_block(sd, src, b, d)
        for n in ("query", "key", "value"):
            sd[src + f"attention.attention.{n}.weight"] = getattr(b.attn, n).kernel.reshape(d, d).t()
            sd[src + f"attention.attention.{n}.bias"] = getattr(b.attn, n).bias.reshape(d)
    return {k: v.detach() for k, v in sd.items()}


def hf_swin_state_dict(m):
    """A port Swin's tensors under HF ``SwinModel``'s names (the inverse of
    ``convert_hf_swin``: HF's patch merging concatenates the 2x2 sub-grids in
    the order [(0,0),(1,0),(0,1),(1,1)], a permutation of the port's that is
    its own inverse)."""
    import torch

    cfg = m.cfg
    sd = {"embeddings.patch_embeddings.projection.weight": _split_patch(m.patch_embed.kernel),
          "embeddings.patch_embeddings.projection.bias": m.patch_embed.bias,
          "embeddings.norm.weight": m.patch_ln.scale, "embeddings.norm.bias": m.patch_ln.bias,
          "layernorm.weight": m.final_ln.scale, "layernorm.bias": m.final_ln.bias}
    dim = cfg.embed_dim
    for s, depth in enumerate(cfg.depths):
        if s > 0:
            red, ln = getattr(m, f"merge{s}"), getattr(m, f"merge_ln{s}")
            perm = torch.cat([torch.arange(dim) + j * dim for j in (0, 2, 1, 3)]).to(red.kernel.device)
            down = f"encoder.layers.{s - 1}.downsample."
            sd[down + "reduction.weight"] = red.kernel[perm].t()
            sd[down + "norm.weight"], sd[down + "norm.bias"] = ln.scale[perm], ln.bias[perm]
            dim *= 2
        for i in range(depth):
            b, src = getattr(m, f"stage{s}_block{i}"), f"encoder.layers.{s}.blocks.{i}."
            _hf_block(sd, src, b, dim)
            for j, n in enumerate(("query", "key", "value")):
                sd[src + f"attention.self.{n}.weight"] = b.qkv.kernel[:, j].reshape(dim, dim).t()
                sd[src + f"attention.self.{n}.bias"] = b.qkv.bias[j].reshape(dim)
            sd[src + "attention.self.relative_position_bias_table"] = b.rel_pos_table
    return {k: v.detach() for k, v in sd.items()}


def hf_import_check(seed):
    """(f) ViT-B/16 and Swin-T at their published widths, drawn from the seed on the
    card, written out under HF's names (no ``transformers``), read back through
    ``convert_hf_vit`` / ``convert_hf_swin`` into fresh port encoders on the card:
    every tensor equal, and the eval outputs at full width (1520x912, 1536x1024)
    the same bits."""
    import torch

    from mammo_clip_tpu_torch.convert.from_jax import load_jax_variables
    from mammo_clip_tpu_torch.convert.torch_import import convert_hf_swin, convert_hf_vit
    from mammo_clip_tpu_torch.models import (SwinConfig, SwinTransformer, ViT, ViTConfig,
                                             init_parameters)

    out = {}
    cases = (("vit", lambda: ViT(ViTConfig()), hf_vit_state_dict,
              lambda sd: convert_hf_vit(sd, num_heads=12), (1520, 912)),
             ("swin", lambda: SwinTransformer(SwinConfig()), hf_swin_state_dict,
              lambda sd: convert_hf_swin(sd, num_heads=(3, 6, 12, 24)), (1536, 1024)))
    for fam, make, to_hf, convert, hw in cases:
        t = time.perf_counter()
        src = make().cuda().eval()
        init_parameters(src, torch.Generator(device="cuda").manual_seed(seed))
        hf = to_hf(src)
        dst = make()
        load_jax_variables(dst, {"params": convert(hf)})
        dst = dst.cuda().eval()
        a, b = src.state_dict(), dst.state_dict()
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        x = torch.rand(1, *hw, 1, generator=torch.Generator(device="cuda").manual_seed(seed),
                       device="cuda")
        n0 = flash_counts()
        with torch.no_grad():
            ya, yb = src(x), dst(x)
        torch.cuda.synchronize()
        flash = [c - d for c, d in zip(flash_counts(), n0)]
        same = all(torch.equal(ya[k], yb[k]) for k in ya)
        finite = all(bool(torch.isfinite(v).all()) for v in ya.values())
        seconds = time.perf_counter() - t
        say(f"[fam] (f) {fam}: {len(hf)} HF-named tensors on the card -> "
            f"convert_hf_{fam} -> the port's encoder: {len(a) - len(differ)} of {len(a)} "
            f"tensors equal, outputs at {hw[0]}x{hw[1]} "
            f"{ {k: tuple(v.shape) for k, v in ya.items()} } the same bits {same}, finite "
            f"{finite}, flash launches fwd/bwd {flash}, {seconds:.1f} s")
        if differ or not same or not finite or flash != ([24, 0] if fam == "vit" else [0, 0]):
            raise SmokeFailure(f"HF {fam} import on the card: {len(differ)} tensors differ "
                               f"({differ[:3]}), same outputs {same}, finite {finite}, "
                               f"flash {flash}")
        out[fam] = dict(tensors=len(a), seconds=seconds)
        del src, dst, hf, ya, yb
    return out


def families_phase(seed, workdir):
    """Phase 15 on phase 7's run (``workdir``, whose B5 best/ (e) reads): (a) flash
    at the ViT shape, (b) each family card vs CPU, (c) the full-width compat step
    of each family, (d) the ViT through the CLIs, (e) FActOR, (f) the HF
    importers on the card, (g) the phase's seconds. Returns (numbers, the flash
    rows of the kernels line at the ViT shape)."""
    import tempfile

    card = card_line()
    say(f"[fam] phase 15 on {card}")
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_fam_"))
    try:
        out = {"flash": vit_flash_check(seed)}
        out["reference"] = family_reference_check(seed)
        out["steps"] = family_steps(seed)
        out["vit_cli"] = vit_cli(seed, tmp)
        out["factor"] = factor_phase(workdir, tmp)
        out["hf"] = hf_import_check(seed)
        out["seconds"] = time.perf_counter() - t_phase
        st = out["steps"]
        say(f"[fam] (g) phase 15: {out['seconds']:.1f} s on {card}; "
            + "; ".join(f"{r['name']} {sum(r['step_ms']) / len(r['step_ms']):.1f} ms a step, "
                        f"{r['images_per_s']:.2f} images/s, {r['peak_bytes'] / 2**30:.2f} GiB"
                        for r in st.values())
            + f"; cli/factor {out['factor']['seconds']:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fl = out["flash"]
    rows = [{"name": f"flash_attention[vit_b16].{direction}", "route": "cuda",
             "source": "mammo_clip_tpu_torch/csrc/flash_attention.cu",
             "replaces": "benchmarks/probe_flash_attention.py:45",
             "launches": out["steps"]["vit"]["flash"][i], "max_abs_err": fl["err"][i],
             "ms": fl["device"]["kernel"][i], "plain_ms": fl["device"]["plain"][i],
             "bound_ms": fl["bounds"][i][0], "bound_by": fl["bounds"][i][1],
             "library_ms": fl["device"]["sdpa"][i], "event_ms": fl["times"]["kernel"][i]}
            for i, direction in enumerate(("forward", "backward"))]
    return out, rows


# --------------------------------------------------------------------------
# phase 16: int8 k5 convs, the serving export and profiling
# --------------------------------------------------------------------------

# B5's k5 1x1 convs at 1520x912, batch 16, NCHW input and output channels:
# each stage's entry expand, in-stage expand and in-stage project
QUANT_CASES = (("s3_entry_expand", (16, 40, 380, 228), 240),
               ("s3_expand", (16, 64, 190, 114), 384),
               ("s3_project", (16, 384, 190, 114), 64),
               ("s5_entry_expand", (16, 128, 95, 57), 768),
               ("s5_expand", (16, 176, 95, 57), 1056),
               ("s5_project", (16, 1056, 95, 57), 176),
               ("s6_entry_expand", (16, 176, 95, 57), 1056),
               ("s6_expand", (16, 304, 48, 29), 1824),
               ("s6_project", (16, 1824, 48, 29), 304))
QUANT_CHECK_ROWS = 4  # image rows of each case whose int32 product the CPU recomputes
QUANT_BWD_CASES = ("s6_expand", "s6_project")  # the straight-through backward, card vs CPU
# card vs CPU, unit-norm embeddings of the int8 encoder: a quantised value within
# the two sides' fp32 convolution round-off (~1e-7) of a .5 boundary flips by an
# int8 step; in eval mode a flip moves one conv output by one step of its scale
INT8_EMBED_TOL = 5e-3
EXPORT_BATCH = 8
EXPORT_TIMED_CALLS = 3
EXPORT_EMBED_TOL = 1e-4  # the artifact against eager, both fp32 with TF32 off
FLASH_FWD_KERNEL = re.compile(r"\b(fwd|fwd_tc)_kernel<")


def quant_kernel_cases(seed):
    """(a) ``int8_conv1x1`` at B5's k5 shapes: card vs CPU (the int8 operands
    and scales in full, the int32 product and the dequantised output on the
    first QUANT_CHECK_ROWS image rows, exact up to 1 ulp; the straight-through
    backward on QUANT_BWD_CASES, within 1e-5 of the largest), then its forward,
    ``torch._int_mm`` alone and a bf16 ``torch.matmul`` of the same (M, K) x (K,
    N) (the library time), CUDA events."""
    import torch

    from mammo_clip_tpu_torch.ops.quant import (
        int8_conv1x1,
        int_matmul,
        quantize_per_column,
        quantize_per_tensor,
    )

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for name, (n, c, h, w), cout in QUANT_CASES:
        x = torch.randn(n, c, h, w, device="cuda", generator=g)
        kernel = 0.05 * torch.randn(cout, c, 1, 1, device="cuda", generator=g)
        out = int8_conv1x1(x, kernel, torch.float32)
        qx, sx = quantize_per_tensor(x)
        xc, kc = x.cpu(), kernel.cpu()
        qxc, sxc = quantize_per_tensor(xc)
        qwc, swc = quantize_per_column(kc[:, :, 0, 0].t())
        same_q = bool(torch.equal(qx.cpu(), qxc)) and float(sx) == float(sxc)
        r = QUANT_CHECK_ROWS
        part = qxc[:, :, :r].permute(0, 2, 3, 1).reshape(-1, c)
        want = (int_matmul(part, qwc).float() * (sxc * swc)).reshape(n, r, w, cout)
        got = out[:, :, :r].permute(0, 2, 3, 1).cpu()
        err = float((got - want).abs().max() / want.abs().max())
        m = n * h * w
        a = torch.randn(m, c, device="cuda", dtype=torch.bfloat16, generator=g)
        b = torch.randn(c, cout, device="cuda", dtype=torch.bfloat16, generator=g)
        qa = torch.randint(-127, 128, (m, c), device="cuda", dtype=torch.int8, generator=g)
        qb = torch.randint(-127, 128, (c, cout), device="cuda", dtype=torch.int8, generator=g)
        row = dict(case=name, m=m, k=c, n=cout, same_int8=same_q, err=err,
                   ms=time_ms(lambda: int8_conv1x1(x, kernel, torch.float32)),
                   int_mm_ms=time_ms(lambda: int_matmul(qa, qb)),
                   bf16_matmul_ms=time_ms(lambda: a @ b))
        if name in QUANT_BWD_CASES:
            go = torch.randn(n, cout, h, w, device="cuda", generator=g)
            grads = []
            for xs, ks, gs in ((x, kernel, go), (xc, kc, go.cpu())):
                xs, ks = xs.clone().requires_grad_(), ks.clone().requires_grad_()
                int8_conv1x1(xs, ks, torch.float32).backward(gs)
                grads.append((xs.grad.cpu(), ks.grad.cpu()))
            row["bwd_err"] = max(float((a_ - b_).abs().max() / b_.abs().max())
                                 for a_, b_ in zip(*grads))
        say(f"[int8] (a) {name}: x {(n, c, h, w)} -> {cout} (M {m}, K {c}, N {cout}): int8 "
            f"operands and scale equal on card and CPU {same_q}, int32 product rows "
            f"0-{r - 1} rel err {err:.2e} (tol 1.2e-7)"
            + (f", backward rel err {row['bwd_err']:.2e} (tol 1e-5)" if "bwd_err" in row else "")
            + f"; int8_conv1x1 fwd {row['ms']:.4f} ms, torch._int_mm alone "
              f"{row['int_mm_ms']:.4f} ms, bf16 torch.matmul {row['bf16_matmul_ms']:.4f} ms")
        if not (same_q and err <= 1.2e-7 and row.get("bwd_err", 0.0) <= 1e-5):
            raise SmokeFailure(f"int8_conv1x1 {name}: card vs CPU {row}")
        rows.append(row)
        del x, kernel, out, qx, a, b, qa, qb
    torch.cuda.empty_cache()
    return rows


def quant_serving(seed, best, serving):
    """(b) The compat B5 encoder from phase 7's best/ with ``quant_int8_k5`` in
    eval mode, fp32: card vs CPU on 2 images, then images/s and peak memory at
    batch SERVE_BATCH (SERVE_TIMED_BATCHES after one warm-up, host clock) beside
    phase 10's fp32 figures, and the cosine of its embeddings to the fp32
    model's (information, not a gate)."""
    import gc

    import numpy as np
    import torch

    from mammo_clip_tpu_torch.data.images import SyntheticImageStore
    from mammo_clip_tpu_torch.eval.embeddings import EmbeddingExtractor
    from mammo_clip_tpu_torch.eval.loading import load_clip_for_eval
    from mammo_clip_tpu_torch.models import build_model

    fp32, cfg = load_clip_for_eval(best, device="cuda")
    cfg.model.image_encoder.quant_int8_k5 = True
    h, w = cfg.data.image_size_h, cfg.data.image_size_w
    ramp = np.broadcast_to(np.linspace(0, 255, w).astype(np.uint8), (h, w))
    two = np.stack([SyntheticImageStore((h, w)).get("q0", "a.png"), ramp])[..., None]
    embs = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg.model.to_dict(), device=device)
        model.load_state_dict(fp32.state_dict())
        embs[device] = EmbeddingExtractor(model, cfg.data.mean, cfg.data.std,
                                          batch_size=2).encode_images(two)
        if device == "cuda":
            q8 = model
    err = float(np.abs(embs["cuda"] - embs["cpu"]).max())
    ex = EmbeddingExtractor(q8, cfg.data.mean, cfg.data.std, batch_size=SERVE_BATCH)
    rng = np.random.default_rng(seed)
    n = SERVE_BATCH * SERVE_TIMED_BATCHES
    imgs = rng.integers(0, 256, (SERVE_BATCH + n, h, w, 1), dtype=np.uint8)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    emb_q8 = ex.encode_images(imgs[:SERVE_BATCH])  # warm-up batch
    img_s = host_timed(lambda: ex.encode_images(imgs[SERVE_BATCH:]))
    peak = torch.cuda.max_memory_allocated()
    emb_fp = EmbeddingExtractor(fp32, cfg.data.mean, cfg.data.std,
                                batch_size=SERVE_BATCH).encode_images(imgs[:SERVE_BATCH])
    cos = (emb_q8 * emb_fp).sum(axis=1)
    fp = serving["throughput"]
    out = dict(err=err, images_per_s=n / img_s, batch_ms=1e3 * img_s / SERVE_TIMED_BATCHES,
               peak_bytes=peak, cosine_min=float(cos.min()), cosine_mean=float(cos.mean()))
    say(f"[int8] (b) compat B5 with quant_int8_k5 at {h}x{w}, fp32, eval: card vs CPU on 2 "
        f"images, unit-norm embeddings max|diff| {err:.2e} (tol {INT8_EMBED_TOL:g}); "
        f"encode_images {out['images_per_s']:.2f} images/s ({out['batch_ms']:.1f} ms a batch "
        f"of {SERVE_BATCH}, {SERVE_TIMED_BATCHES} batches after 1 warm-up, host clock), peak "
        f"memory {peak} B ({peak / 2**30:.2f} GiB); phase 10's fp32: "
        f"{fp['images_per_s']:.2f} images/s ({fp['image_batch_ms']:.1f} ms), "
        f"{fp['peak_bytes'] / 2**30:.2f} GiB; cosine int8 vs fp32 embeddings over "
        f"{SERVE_BATCH} images: min {out['cosine_min']:.6f}, mean {out['cosine_mean']:.6f} "
        f"(information)")
    if not err <= INT8_EMBED_TOL:
        raise SmokeFailure(f"int8 serving: card vs CPU embeddings differ by {err:.2e}")
    del fp32, q8, ex
    gc.collect()
    torch.cuda.empty_cache()
    return out


def quant_train_steps(seed, slice_rows):
    """(c) The compat recipe with ``quant_int8_k5`` and the fused route: STEPS
    train steps at full width, batch BATCH, 14 + 14 fused calls each, a finite
    loss, the step times beside phase 5's."""
    import gc

    import torch

    from mammo_clip_tpu_torch.ops.mbconv import launches
    from mammo_clip_tpu_torch.train.recipes import bench_recipe_config, build_bench_train

    cfg = bench_recipe_config(compat=True)
    cfg.model.image_encoder.quant_int8_k5 = True
    model, _, state, _, train_step = build_bench_train(cfg, device="cuda", seed=seed)
    enc = model.image_encoder
    n_int8 = sum(enc.quant_ok(a, 1, 1) for a in enc.block_args)
    batch = synthetic_batch(cfg, BATCH, seed, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    launches.reset()
    rows = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(STEPS):
        f0, b0 = launches.total("mbconv6", "forward"), launches.total("mbconv6", "backward")
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, loss = train_step(state, batch, gen)
        total = float(loss["total"])
        torch.cuda.synchronize()
        rows.append(dict(loss=total, ms=(time.perf_counter() - t) * 1e3,
                         fused=(launches.total("mbconv6", "forward") - f0,
                                launches.total("mbconv6", "backward") - b0)))
        if not math.isfinite(total):
            raise SmokeFailure(f"int8 compat step {i}: loss is not finite")
    peak = torch.cuda.max_memory_allocated()
    say(f"[int8] (c) compat B5 step with quant_int8_k5 ({n_int8} int8 blocks) and the fused "
        f"route, batch {BATCH}, bf16: losses {[round(r['loss'], 6) for r in rows]}, ms a step "
        f"{[round(r['ms'], 1) for r in rows]} (phase 5's fp path: "
        f"{[round(r['ms'], 1) for r in slice_rows]}), fused calls per step "
        f"{[r['fused'] for r in rows]}, peak memory {peak} B ({peak / 2**30:.2f} GiB)")
    if any(r["fused"] != (14, 14) for r in rows) or n_int8 != 21:
        raise SmokeFailure(f"int8 compat steps: fused calls {[r['fused'] for r in rows]}, "
                           f"{n_int8} int8 blocks (expected 14 + 14 and 21)")
    del model, state, train_step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return dict(steps=rows, peak_bytes=peak, int8_blocks=n_int8)


def serve_bare(out_dir, images_path, calls, extra=""):
    """Load ``out_dir`` with ``ServingModule`` from utils/export.py's file in a
    fresh process that cannot import this package, JAX or the JAX package; embed
    the saved images ``calls`` + 1 times. Returns its JSON record: load seconds,
    ms a call after the first (host clock, ending in a copy to the host), the
    embeddings' path and the package modules it loaded."""
    code = textwrap.dedent(f"""
        import importlib.util, json, sys, time
        for name in ("mammo_clip_tpu_torch", "mammo_clip_tpu", "jax", "jaxlib"):
            sys.modules[name] = None
        import numpy as np, torch
        t = time.perf_counter()
        spec = importlib.util.spec_from_file_location(
            "serving_export", {str(ROOT / "mammo_clip_tpu_torch" / "utils" / "export.py")!r})
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        srv = mod.ServingModule({str(out_dir)!r}, "cuda")
        x = torch.from_numpy(np.load({str(images_path)!r})).cuda()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        ms = []
        for i in range({calls} + 1):
            t = time.perf_counter()
            emb = srv.embed_images(x).cpu().numpy()
            ms.append(1e3 * (time.perf_counter() - t))
        np.save({str(out_dir / "bare_embeddings.npy")!r}, emb)
        loaded = sorted(m for m in sys.modules if m.startswith(("mammo_clip", "jax"))
                        and sys.modules[m] is not None)
        print(json.dumps(dict(load_s=load_s, first_ms=ms[0], ms=ms[1:], loaded=loaded,
                              tf32_default=torch.backends.cudnn.allow_tf32)))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(out_dir))
    if res.returncode != 0:
        raise SmokeFailure(f"loading the artifact{extra} in a bare process failed:\n"
                           f"{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def export_cli_phase(seed, best, tmp):
    """(d) cli/export on phase 7's best/ at 1520x912, batch EXPORT_BATCH, on the
    card; the artifact loaded and called in a bare process; its embeddings
    against EmbeddingExtractor's on the same batch (eager, fp32, TF32 off)."""
    import numpy as np
    import torch

    from mammo_clip_tpu_torch.cli import export
    from mammo_clip_tpu_torch.eval.embeddings import EmbeddingExtractor
    from mammo_clip_tpu_torch.eval.loading import load_clip_for_eval
    from mammo_clip_tpu_torch.ops.augment import minmax_standardize

    out = tmp / "b5_served"
    t = time.perf_counter()
    res = export.main(["--checkpoint", best, "--out", str(out), "--batch", str(EXPORT_BATCH),
                       "--device", "cuda"])
    export_s = time.perf_counter() - t
    manifest = json.loads((out / "serving.json").read_text())
    sizes = {k: Path(v).stat().st_size for k, v in res["exported"].items()}
    model, cfg = load_clip_for_eval(best, device="cuda")
    h, w = cfg.data.image_size_h, cfg.data.image_size_w
    raw = np.random.default_rng(seed).integers(0, 256, (EXPORT_BATCH, h, w, 1), dtype=np.uint8)
    x = minmax_standardize(torch.from_numpy(raw).cuda(), cfg.data.mean, cfg.data.std)
    np.save(tmp / "b5_images.npy", x.cpu().numpy())
    ex = EmbeddingExtractor(model, cfg.data.mean, cfg.data.std, batch_size=EXPORT_BATCH)
    want = ex.encode_images(raw)
    eager_ms = [1e3 * host_timed(lambda: ex.encode_images(raw))
                for _ in range(EXPORT_TIMED_CALLS)]
    del model, ex, x
    torch.cuda.empty_cache()
    bare = serve_bare(out, tmp / "b5_images.npy", EXPORT_TIMED_CALLS)
    err = float(np.abs(np.load(out / "bare_embeddings.npy") - want).max())
    say(f"[export] (d) cli/export on phase 7's best/ ({h}x{w}, batch {EXPORT_BATCH}, cuda): "
        f"{export_s:.1f} s, files {sizes} B, requires {manifest['requires']}; a bare process "
        f"(this package, JAX and the JAX package unimportable; cuDNN TF32 at start "
        f"{bare['tf32_default']}) loaded it in {bare['load_s']:.1f} s, loaded package modules "
        f"{bare['loaded']}; artifact ms a batch {[round(m, 1) for m in bare['ms']]} after a "
        f"first of {bare['first_ms']:.1f}, eager extractor {[round(m, 1) for m in eager_ms]}; "
        f"embeddings max|diff| vs the extractor {err:.2e} (tol {EXPORT_EMBED_TOL:g})")
    if manifest["requires"] != {"cuda": []} or bare["loaded"] or manifest["image_input"] != [
            EXPORT_BATCH, h, w, 1] or not err <= EXPORT_EMBED_TOL:
        raise SmokeFailure(f"cli/export artifact: manifest {manifest}, bare process {bare}, "
                           f"embeddings differ by {err:.2e}")
    shutil.rmtree(out, ignore_errors=True)
    return dict(export_s=export_s, load_s=bare["load_s"], artifact_ms=bare["ms"],
                first_ms=bare["first_ms"], eager_ms=eager_ms, err=err, bytes=sizes)


def profile_fresh(out_dir, images_path, trace_dir):
    """Load the artifact at ``out_dir`` with ``ServingModule`` in a fresh process
    (its ``requires`` imported), call it once to warm up, then once inside
    ``utils/profiling.profile_trace(trace_dir)``. Returns that process's JSON
    record: the flash forward launches its counters saw in the profiled call,
    and the trace's kernels. A process of its own: minutes into the smoke an
    in-process trace keeps only part of a call's kernels on the H100."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np, torch
        from mammo_clip_tpu_torch.utils import profile_trace
        from mammo_clip_tpu_torch.utils.export import ServingModule
        srv = ServingModule({str(out_dir)!r}, "cuda")
        from mammo_clip_tpu_torch.ops.flash_attention import launches
        x = torch.from_numpy(np.load({str(images_path)!r})).cuda()
        srv.embed_images(x)
        torch.cuda.synchronize()
        before = launches.counts["flash_attention.forward"]
        with profile_trace({str(trace_dir)!r}):
            srv.embed_images(x)
            torch.cuda.synchronize()
        print(json.dumps(dict(launched=launches.counts["flash_attention.forward"] - before)))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(ROOT))
    if res.returncode != 0:
        raise SmokeFailure(f"profiling the artifact in a fresh process failed:\n"
                           f"{res.stderr[-3000:]}")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    events = json.loads((Path(trace_dir) / "trace.json").read_text())["traceEvents"]
    out["kernels"] = [e for e in events if e.get("cat") == "kernel"]
    return out


def vit_export_phase(seed, tmp):
    """(e) A ViT-B/16 CLIP (random weights from the seed, BERT-base) exported on the
    card at 1520x912, batch BATCH, fp32: the image program's flash-operator nodes
    (12, one a layer) and no softmax or SDPA, the loaded artifact's embeddings
    against the eager model's, its flash launches (counters, 12 a call); (f) in
    a fresh process, ``profile_trace`` around one eval batch of the loaded
    artifact: the trace's flash forward kernels (12 or more) and the
    counters' launches."""
    import numpy as np
    import torch

    from mammo_clip_tpu_torch.models import build_model
    from mammo_clip_tpu_torch.ops.flash_attention import launches as fa_launches
    from mammo_clip_tpu_torch.train.recipes import bench_recipe_config
    from mammo_clip_tpu_torch.utils.device import full_fp32
    from mammo_clip_tpu_torch.utils.export import ServingModule, export_clip_serving

    cfg = bench_recipe_config(compat=True)
    cfg.model.image_encoder.name = "vit-base"
    h, w, s = cfg.data.image_size_h, cfg.data.image_size_w, cfg.data.text_max_length
    model = build_model(cfg.model.to_dict(), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(seed)).eval()
    out = tmp / "vit_served"
    t = time.perf_counter()
    files = export_clip_serving(model, (h, w), s, batch=BATCH, out_dir=str(out))
    export_s = time.perf_counter() - t
    program = torch.export.load(files["image_fn.cuda"])
    nodes = sum("mammo_clip_tpu_torch.flash_forward" in str(n.target)
                for n in program.graph.nodes)
    plain = sum("scaled_dot_product" in str(n.target) or "softmax" in str(n.target)
                for n in program.graph.nodes)
    del program
    manifest = json.loads((out / "serving.json").read_text())
    srv = ServingModule(str(out))
    x = torch.randn(BATCH, h, w, 1, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(seed))
    before = fa_launches.counts["flash_attention.forward"]
    got = srv.embed_images(x)
    torch.cuda.synchronize()
    launched = fa_launches.counts["flash_attention.forward"] - before
    with torch.no_grad(), full_fp32():
        want = model.embed_image(x)
    err = float((got - want).abs().max())
    say(f"[export] (e) ViT-B/16 CLIP exported on cuda at {h}x{w}, batch {BATCH}, fp32: "
        f"{export_s:.1f} s; image program nodes of the flash operator {nodes} (expected 12), "
        f"of SDPA or softmax {plain}; requires {manifest['requires']}; one loaded-artifact "
        f"call launched the flash forward {launched} times (counters); embeddings max|diff| vs "
        f"eager {err:.2e} (tol {EXPORT_EMBED_TOL:g})")
    np.save(tmp / "vit_images.npy", x.cpu().numpy())
    del model, srv, got, want, x
    torch.cuda.empty_cache()
    trace_dir = tmp / "trace16"
    fresh = profile_fresh(out, tmp / "vit_images.npy", trace_dir)
    flash = [e for e in fresh["kernels"] if FLASH_FWD_KERNEL.search(e["name"])]
    say(f"[export] (f) profile_trace around one eval batch of the loaded artifact, in a fresh "
        f"process: {trace_dir.name}/trace.json, {len(fresh['kernels'])} kernels, {len(flash)} "
        f"of them the flash forward ({sorted({short_name(e['name']) for e in flash})}, "
        f"{sum(e['dur'] for e in flash) / 1e3:.2f} ms of device time); its counters "
        f"{fresh['launched']} launches")
    if nodes != 12 or plain or launched != 12 or fresh["launched"] != 12 or len(flash) < 12 \
            or not err <= EXPORT_EMBED_TOL \
            or manifest["requires"] != {"cuda": ["mammo_clip_tpu_torch.ops.flash_attention"]}:
        raise SmokeFailure(f"ViT export: {nodes} flash nodes, {plain} plain attention nodes, "
                           f"{launched} / {fresh['launched']} launches, {len(flash)} traced "
                           f"flash kernels, embeddings differ by {err:.2e}, requires "
                           f"{manifest['requires']}")
    return dict(export_s=export_s, nodes=nodes, launched=launched, traced=len(flash),
                err=err, flash_device_ms=sum(e["dur"] for e in flash) / 1e3)


def int8_export_phase(seed, workdir, serving, slice_rows):
    """Phase 16 on phase 7's run (``workdir``): (a) int8_conv1x1 at B5's k5
    shapes, (b) int8 serving, (c) int8 compat steps, (d) cli/export and a bare
    process, (e) a ViT exported on the card, (f) profile_trace, then the
    phase's seconds."""
    import tempfile

    card = card_line()
    say(f"[int8] phase 16 on {card}")
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_p16_"))
    best = str(workdir / "best")
    try:
        out = {"kernels": quant_kernel_cases(seed)}
        out["serving"] = quant_serving(seed, best, serving)
        out["train"] = quant_train_steps(seed, slice_rows)
        out["export"] = export_cli_phase(seed, best, tmp)
        out["vit"] = vit_export_phase(seed, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    say(f"[export] (g) phase 16: {out['seconds']:.1f} s on {card}")
    return out


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


def flash_timing(q, k, v, g):
    """bf16 forward, backward and forward+backward at q's (B, N, S, D) shape, for
    the kernel (its launches alone), the plain version, the port's
    ``amp_attn_scores`` einsum attention and SDPA: (CUDA-event ms, device ms,
    bounds), each by name, then by direction."""
    import torch
    import torch.nn.functional as F

    from mammo_clip_tpu_torch.benchmarks.layout_timing import device_ms
    from mammo_clip_tpu_torch.models.bert import attention
    from mammo_clip_tpu_torch.ops.flash_attention import (
        flash_backward,
        flash_forward,
        plain_flash_attention,
    )

    shape = tuple(q.shape)
    scale = shape[-1] ** -0.5
    mask = torch.ones(shape[0], shape[2], dtype=torch.bool, device="cuda")
    fns = {
        "plain": lambda q, k, v: plain_flash_attention(q, k, v, scale),
        "einsum": lambda q, k, v: attention(q * scale, k, v, mask, amp_scores=True),
        "sdpa": lambda q, k, v: F.scaled_dot_product_attention(q, k, v, scale=scale),
    }
    o, lse = flash_forward(q, k, v, scale)
    calls = {"kernel": (  # the launches alone (flash_forward's are counted, never read here)
        lambda: flash_forward(q, k, v, scale),
        lambda: flash_backward(q, k, v, o, lse, g, scale),
        lambda: flash_backward(q, k, v, *flash_forward(q, k, v, scale), g, scale))}
    times, device = {}, {}
    for name, (fwd, bwd, both) in calls.items():
        times[name] = tuple(time_ms(c) for c in (fwd, bwd, both))
        device[name] = tuple(device_ms(c) for c in (fwd, bwd, both))
    del calls
    for name, fn in fns.items():  # one graph held at a time (S = 5416: GBs of scores)
        qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
        out = fn(qr, kr, vr)
        trio = (lambda: fn(q, k, v).detach(),
                lambda: torch.autograd.grad(out, (qr, kr, vr), g, retain_graph=True),
                lambda: torch.autograd.grad(fn(qr, kr, vr), (qr, kr, vr), g))
        times[name] = tuple(time_ms(c) for c in trio)
        device[name] = tuple(device_ms(c) for c in trio)
        del out, trio
    elems, s2 = q.numel(), shape[0] * shape[1] * shape[2] ** 2 * shape[3]
    stats = 4 * shape[0] * shape[1] * shape[2]
    mm = lambda flops: {"products": (flops, BF16_FLOPS)}
    bounds = [bound(4 * 2 * elems + stats, mm(4 * s2)),   # q, k, v in; o, lse out
              bound(8 * 2 * elems + stats, mm(10 * s2)),  # q, k, v, o, dO, lse in; dq, dk, dv out
              bound(8 * 2 * elems, mm(14 * s2))]          # q, k, v, dO in; o, dq, dk, dv out
    return times, device, bounds


def flash_phases(seed, earlier=None):
    """Phase 8. Returns the forward and backward rows of the kernels line; with
    ``earlier`` (parent_turns'), their earlier_host_us."""
    import torch

    from mammo_clip_tpu_torch.benchmarks import layout_timing
    from mammo_clip_tpu_torch.benchmarks import probe_flash_attention as probe
    from mammo_clip_tpu_torch.ops import cuda_lib
    from mammo_clip_tpu_torch.ops import flash_attention as flash_module
    from mammo_clip_tpu_torch.ops.flash_attention import flash_backward, flash_forward, launches

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
    o, lse = flash_forward(q, k, v, scale)
    first, second = (flash_backward(q, k, v, o, lse, g, scale) for _ in range(2))
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(first, second)]
    say(f"[flash check] {shape} bf16 backward twice on the same inputs: dq, dk, dv "
        f"bit-identical {same}")
    if not all(same):
        raise SmokeFailure(f"flash backward is not deterministic: {same}")
    del o, lse, first, second
    times, device, bounds = flash_timing(q, k, v, g)
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
        # 13. offline preprocessing into training, cli/detector on the same best/
        pre = preprocess_phase(args.seed, cli_tmp / "run")
        # 14. the flagship, warm-started from the same best/
        flag = flagship_phase(args.seed, cli_tmp / "run")
        # 15. the other encoder families, and Mammo-FActOR on the same best/
        fam, fam_rows = families_phase(args.seed, cli_tmp / "run")
        # 16. int8 k5 convs, the serving export of the same best/, profiling
        int8 = int8_export_phase(args.seed, cli_tmp / "run", serving, rows)
    finally:
        shutil.rmtree(cli_tmp, ignore_errors=True)
    (OUT_DIR / "chip_smoke_steps.json").write_text(
        json.dumps(dict(slice=rows, cli=cli, serving=serving, classifier=clf, detector=det,
                        preprocess=pre, flagship=flag, families=fam, int8_export=int8),
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
    lines += flash_rows + fam_rows + probe_rows
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
