"""The counts the benchmark holds the program to, against hand counts: the
fused MBConv and flash bounds, the model FLOPs of B0, ViT and BERT, and the
reduction of a profile to busy time, idle gaps and shares."""

import math

import pytest

from portbench.harness.result import Run
from portbench.harness.trace import Profile, gaps_of, union_s
from portbench.reference import flops
from portbench.reference.efficientnet import blocks

from .conftest import BENCH


def test_mbconv_bound_by_hand():
    # block 4 of B5 at batch 8: e6, C = 40, E = 240, C2 = 40, squeeze 10, 380x228
    p = 8 * 380 * 228
    nparam = 9 * 240 + 2 * 240 + 2 * 240 * 10 + 10 + 240 + 240 * 40 + 2 * 40 + 40 * 240 + 2 * 240
    fwd = max((2 * p * 80 + 4 * nparam) / 3.35e12, 2 * 2 * p * 240 * 40 / 989e12,
              2 * 9 * p * 240 / 67e12)
    bwd = max((2 * p * 120 + 8 * nparam) / 3.35e12, 2 * 2 * 2 * p * 240 * 40 / 989e12,
              2 * 2 * 9 * p * 240 / 67e12)
    assert flops.mbconv_bound_s("e6", 8, 40, 240, 40, 10, 380, 228, False) == pytest.approx(fwd)
    assert flops.mbconv_bound_s("e6", 8, 40, 240, 40, 10, 380, 228, True) == pytest.approx(bwd)
    # the stencil bounds it: 9 taps x 2 flops x E a pixel at 67 TFLOP/s
    assert fwd == pytest.approx(2 * 9 * p * 240 / 67e12)


def test_b5_fused_blocks_are_the_programs():
    fused = flops.fused_blocks("b5", 1520, 912)
    assert [f[0] for f in fused] == ["e1"] * 3 + ["e6"] * 4
    assert fused[0][1:] == (48, 48, 24, 12, 760, 456)
    assert fused[3][1:] == (40, 240, 40, 10, 380, 228)


def test_flash_bound_by_hand():
    b, n, s, d = 8, 12, 5416, 64
    fwd = 2 * 2 * b * n * s * s * d / 989e12
    bwd = 4 * 2 * b * n * s * s * d / 989e12
    assert flops.flash_bound_s(b, n, s, d, False) == pytest.approx(fwd)
    assert flops.flash_bound_s(b, n, s, d, True) == pytest.approx(bwd)
    # a short sequence is bound by its bytes: q, k, v in, o and lse out
    assert flops.flash_bound_s(1, 1, 4, 64, False) == pytest.approx(
        (4 * 2 * 4 * 64 + 4 * 4) / 3.35e12)


def test_b0_flops_by_hand():
    """B0 at 32x32: the stem, 16 blocks and the head, counted layer by layer."""
    h = w = 16
    total = 2 * h * w * 32 * 9
    for b in blocks("b0"):
        if b.expand != 1:
            total += 2 * h * w * b.cin * b.cin * b.expand
        h, w = math.ceil(h / b.stride), math.ceil(w / b.stride)
        e = b.cin * b.expand
        total += 2 * h * w * e * b.kernel ** 2 + 4 * e * b.squeeze + 2 * h * w * e * b.cout
    total += 2 * h * w * 320 * 1280
    assert flops.effnet_forward_flops("b0", 32, 32) == pytest.approx(total)
    # the first block: depthwise 3x3 on 32 channels at 16x16, SE 32 -> 8 -> 32, project to 16
    assert blocks("b0")[0].squeeze == 8


def test_bert_and_vit_flops_by_hand():
    t = dict(hidden_size=4, intermediate_size=8, num_layers=2)
    # a layer on 3 tokens: q, k, v, o (4x4 each), the FFN (4x8, 8x4), QK^T and PV
    layer = 2 * 3 * (4 * 16 + 2 * 32) + 2 * (2 * 3 * 3 * 4)
    assert flops.bert_forward_flops(t, 3) == 2 * layer
    v = dict(patch_size=2, hidden_size=4, mlp_dim=8, num_layers=1)
    s = 2 * 2 + 1  # a 4x4 image in 2x2 patches, plus CLS
    layer = 2 * s * (4 * 16 + 2 * 32) + 4 * s * s * 4
    assert flops.vit_forward_flops(v, 4, 4) == 2 * 4 * 4 * 1 * 4 + layer


def test_train_step_is_three_forwards():
    model = {"image_encoder": {"name": "efficientnet-b0"},
             "text_encoder": dict(hidden_size=4, intermediate_size=8, num_layers=1),
             "projection_head": {"proj_dim": 2}}
    fwd = flops.clip_forward_flops(model, 32, 32, 3, 2, 2)
    assert fwd == 2 * (flops.effnet_forward_flops("b0", 32, 32) + 2 * 1280 * 2) + 2 * (
        flops.bert_forward_flops(model["text_encoder"], 3) + 2 * 4 * 2)
    assert flops.train_step_flops(model, 32, 32, 3, 2, 2) == 3 * fwd


def test_union_gaps_and_idle_share():
    intervals = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 7.0)]
    assert union_s(intervals) == pytest.approx(4.0)
    assert gaps_of(intervals) == [(2.0, 3.0), (4.0, 6.0)]
    prof = Profile(device=[("k", s, e) for s, e in intervals],
                   host=[("step", 0.0, 7.0), ("aten::copy_", 3.9, 6.5), ("wait", 1.9, 3.1)],
                   calls=2)
    assert prof.span_s() == 7.0 and prof.busy_s() == pytest.approx(4.0)
    assert prof.idle_gaps() == [("aten::copy_", 2.0), ("wait", 1.0)]
    assert prof.top_ops() == [("k", pytest.approx(4.6))]
    idle = _reader("device_idle_share.train")(Run(profile=prof))
    assert idle == pytest.approx(100 * 3.0 / 7.0)


def test_shares_stay_silent_without_their_kernels():
    prof = Profile(device=[("void at::native::vectorized_elementwise_kernel", 0.0, 1.0)],
                   host=[], calls=1)
    for name in ("mbconv_roofline", "flash_roofline"):
        assert _reader(name)(Run(profile=prof)) is None
        assert _reader(name)(Run()) is None


def test_roofline_reads_its_kernels():
    from portbench.harness import manifest

    cell = manifest.resolve("b5_pretrain_b8")
    bound = flops.mbconv_step_bound_s("b5", 8, 1520, 912, 2)
    names = ["void (anonymous namespace)::sweep_kernel<__nv_bfloat16, 8, 3, 1, true>("
             "(anonymous namespace)::P6)", "(anonymous namespace)::sum_blocks_kernel<4, 8>",
             "void at::native::(anonymous namespace)::out_kernel"]
    prof = Profile(device=[(n, 0.0, bound) for n in names], host=[], calls=2)
    run = Run(profile=prof, config=cell.config, traffic=cell.traffic)
    assert _reader("mbconv_roofline")(run) == pytest.approx(100.0)


def _reader(name):
    from portbench.harness.manifest import load_module

    return load_module(BENCH / "metrics" / f"{name}.py", "t_" + name.replace(".", "_")).read
