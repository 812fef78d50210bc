"""The port's detection path against the JAX package, on the CPU.

* ``ops/boxes``: the anchor lattice bit for bit; IoU, encode (degenerate
  boxes included), decode and clip within 1e-6;
* the three NMS functions on seeded candidate pools with scores tied at 0 and
  exactly at the threshold, batched over slates: the same slates (valid
  slots, order and boxes exactly; scores within 1e-6, soft-NMS's decay being
  a chain of exp);
* ``focal_loss`` with positives, the ignore band and an image without boxes:
  values and the gradients with respect to both predictions within 1e-5;
* the detector tap indices of b0, b2 and b5, and b0's taps within 1e-5;
* the JAX RetinaNet's variable tree (``jax.eval_shape`` of its init) is the
  port's state dict through ``convert/from_jax``; the heads' Flax init;
* RetinaNet (b0 at 64x64, 3 classes) from one init carried across by
  ``convert/from_jax``: class probabilities and deltas within 1e-5; ``detect``
  hard and soft on the same outputs: the same valid slots, classes and scores
  (1e-6), boxes within 1e-5 (decode's exp differs by an ulp);
  ``detect_multiscale`` at (1.0,) equal to ``detect``; at (0.75, 1.0) on
  96x96 images, the resize within 1e-5 of ``jax.image.resize`` (antialiased
  when it shrinks) and every valid detection matched in class, score (1e-4)
  and box (1e-3 px);
* ``augment_batch_with_boxes`` fed JAX's own draws: boxes within 1e-4 px,
  images within 1e-4 of JAX's single-gather warp at the same coordinates;
* two ``make_detector_steps`` train steps: the loss parts and every parameter
  within 1e-5, the backbone's BatchNorm statistics unchanged on both sides;
* ``evaluate_map`` equal to JAX's on random slates.

The JAX model's forward is compiled once per file (``jax_det``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mammo_clip_tpu.downstream import detect as jax_detect_eval
from mammo_clip_tpu.downstream import experiments as jax_experiments
from mammo_clip_tpu.losses.focal import focal_loss as jax_focal_loss
from mammo_clip_tpu.models import efficientnet as jax_efficientnet
from mammo_clip_tpu.models import retinanet as jax_retinanet
from mammo_clip_tpu.ops import augment as jax_aug
from mammo_clip_tpu.ops import boxes as jax_boxes
from mammo_clip_tpu.ops import nms as jax_nms
from mammo_clip_tpu.train.optim import build_optimizer as jax_build_optimizer
from mammo_clip_tpu.train.state import TrainState as JaxTrainState
from mammo_clip_tpu_torch.convert.from_jax import (
    load_jax_variables,
    state_dict_from_jax,
    variables_from_state_dict,
)
from mammo_clip_tpu_torch.downstream import detect as detect_eval
from mammo_clip_tpu_torch.downstream.experiments import make_detector_steps
from mammo_clip_tpu_torch.losses.focal import focal_loss
from mammo_clip_tpu_torch.models import efficientnet, init_parameters
from mammo_clip_tpu_torch.models import retinanet
from mammo_clip_tpu_torch.ops import augment, boxes, nms
from mammo_clip_tpu_torch.train import build_optimizer, create_train_state

H = W = 64
N, C = 2, 3
ENC = {"name": "efficientnet-b0", "in_channels": 1, "drop_connect_rate": 0.0}
MEAN, STD = 0.3089279, 0.25053555
LR = 1e-2
# the step tests' optimizer: the CLI's global-norm clip, under AdamW with eps
# 1e-3 and no decay (both factories' Adam has a fixed eps of 1e-8, whose
# first step takes the sign of gradients that are 0 up to rounding)
STEP_OPT = {"name": "adamw", "lr": LR, "eps": 1e-3, "weight_decay": 0.0, "grad_clip_norm": 0.1}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """1 intra-op thread: the suite runs its files in parallel
    processes, and torch's default of one thread per core in each oversubscribes
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _annotations():
    """(4, 16, 5): boxes on exact anchors of the 64x64 lattice (positives), one
    scaled into the ignore band, an image without boxes; -1 rows pad."""
    anchors = boxes.build_anchors((H, W))
    ann = -np.ones((4, 16, 5), np.float32)
    ann[0, 0] = [*anchors[40], 0]
    ann[0, 1] = [*anchors[600], 2]
    a = anchors[300]
    cx, cy, w, h = (a[0] + a[2]) / 2, (a[1] + a[3]) / 2, a[2] - a[0], a[3] - a[1]
    ann[1, 0] = [cx - 0.75 * w, cy - 0.75 * h, cx + 0.75 * w, cy + 0.75 * h, 1]  # IoU 0.44
    ann[1, 1] = [5.0, 7.0, 30.0, 20.0, 0]
    ann[3, 0] = [*anchors[10], 1]
    return ann


@pytest.fixture(scope="module")
def jax_det():
    """One init, the port's (``init_parameters`` and ``init_heads``, with
    BatchNorm statistics that are not (0, 1)), carried to the JAX tree by
    ``convert/from_jax`` (``init``; a JAX init would cost one more compile, and
    ``test_port_tree_is_the_jax_tree`` holds the two trees' names and shapes
    equal); a copy with the heads' output layers scaled (``v``: class
    probabilities spread over (0, 1) and boxes move); the JAX model's jitted
    forward (with the backbone's taps) on seeded images."""
    model = jax_retinanet.RetinaNet(image_encoder_config=ENC, num_classes=C)
    port = retinanet.RetinaNet(ENC, C)
    init_parameters(port, torch.Generator().manual_seed(0))
    retinanet.init_heads(port, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, buf in port.named_buffers():
            if name.endswith(".mean"):
                buf.copy_(torch.from_numpy(0.1 * rng.standard_normal(buf.shape)))
            else:
                buf.copy_(torch.from_numpy(1.0 + 0.5 * rng.random(buf.shape)))
    init = variables_from_state_dict(port.state_dict())
    v = jax.tree_util.tree_map(np.copy, init)
    heads = v["params"]
    heads["class_subnet"]["out"]["kernel"] = heads["class_subnet"]["out"]["kernel"] * 50.0
    heads["class_subnet"]["out"]["bias"] = rng.standard_normal(
        heads["class_subnet"]["out"]["bias"].shape).astype(np.float32)
    heads["box_subnet"]["out"]["kernel"] = heads["box_subnet"]["out"]["kernel"] * 5.0
    taps_of = lambda mdl, name: mdl.name == "image_encoder"
    fwd = jax.jit(lambda v, x: model.apply(v, x, train=False, capture_intermediates=taps_of,
                                           mutable=["intermediates"]))
    x = np.random.default_rng(1).standard_normal((N, H, W, 1)).astype(np.float32)
    out, inter = fwd(v, x)
    return dict(model=model, init=init, v=v, fwd=fwd, x=x, out=_np(out),
                taps=_np(inter["intermediates"]["image_encoder"]["__call__"][0]["taps"]))


@pytest.fixture(scope="module")
def port_det(jax_det):
    model = retinanet.RetinaNet(ENC, C)
    load_jax_variables(model, jax_det["v"])
    return model


def test_port_tree_is_the_jax_tree(jax_det):
    """The JAX RetinaNet's variables (``jax.eval_shape`` of its init: names,
    shapes, collections) are the port's state dict through
    ``convert/from_jax``, both ways."""
    shapes = jax.eval_shape(lambda: jax_det["model"].init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, H, W, 1)), train=False))
    flat = lambda tree: {jax.tree_util.keystr(p): tuple(a.shape)
                         for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert flat(shapes) == flat(jax_det["init"])
    assert sorted(shapes["params"]) == ["box_subnet", "class_subnet", "fpn", "image_encoder"]


# ------------------------------------------------------------------ boxes


@pytest.mark.parametrize("shape", [(64, 64), (96, 128), (100, 70), (512, 512)])
def test_anchors_match_jax(shape):
    got = boxes.build_anchors(shape)
    np.testing.assert_array_equal(got, jax_boxes.build_anchors(shape))
    np.testing.assert_array_equal(retinanet.anchors_for(shape), got)
    assert got.dtype == np.float32


def test_box_ops_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 60, (50, 4)).astype(np.float32)
    a[:, 2:] = a[:, :2] + rng.uniform(1, 40, (50, 2)).astype(np.float32)
    b = rng.uniform(0, 60, (30, 4)).astype(np.float32)
    b[:, 2:] = b[:, :2] + rng.uniform(-2, 40, (30, 2)).astype(np.float32)  # some degenerate
    np.testing.assert_allclose(boxes.box_iou(_t(a), _t(b)).numpy(),
                               np.asarray(jax_boxes.box_iou(a, b)), rtol=0, atol=1e-6)
    gt = b[rng.integers(0, 30, 50)]
    enc = boxes.encode_boxes(_t(a), _t(gt)).numpy()
    np.testing.assert_allclose(enc, np.asarray(jax_boxes.encode_boxes(a, gt)),
                               rtol=1e-6, atol=1e-6)
    deltas = rng.normal(0, 1, (50, 4)).astype(np.float32)
    dec = boxes.decode_boxes(_t(a), _t(deltas)).numpy()
    np.testing.assert_allclose(dec, np.asarray(jax_boxes.decode_boxes(a, deltas)),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(boxes.clip_boxes(_t(dec), (48, 40)).numpy(),
                               np.asarray(jax_boxes.clip_boxes(dec, (48, 40))),
                               rtol=0, atol=1e-6)
    # batched: leading dims broadcast as one call per slate
    np.testing.assert_allclose(boxes.box_iou(_t(a)[None].expand(3, 50, 4), _t(b)[None])[1],
                               boxes.box_iou(_t(a), _t(b)))


# ------------------------------------------------------------------ NMS


def _pool(seed, n_slates=3, A=60):
    """Clustered candidate boxes (overlaps to suppress) and per-slate scores,
    a third of them tied at 0 and some exactly at the threshold 0.05."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(10, 90, (6, 2))
    c = centers[rng.integers(0, 6, A)] + rng.normal(0, 3, (A, 2))
    wh = rng.uniform(8, 20, (A, 2))
    bx = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    sc = rng.uniform(0, 1, (n_slates, A)).astype(np.float32)
    sc[:, rng.permutation(A)[: A // 3]] = 0.0
    sc[:, rng.permutation(A)[:4]] = np.float32(0.05)
    return bx, sc


@pytest.mark.parametrize("top_k", [20, 80])  # 80 > A: padded slates
@pytest.mark.parametrize("fn", ["hard", "gaussian", "linear", "class"])
@pytest.mark.parametrize("seed", [0, 1])
def test_nms_matches_jax(fn, top_k, seed):
    bx, sc = _pool(seed)
    if fn == "class":
        got = nms.batched_class_nms(_t(bx), _t(sc.T), 0.5, 0.05, top_k)
        want = jax_nms.batched_class_nms(bx, sc.T, 0.5, 0.05, top_k)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        got, want = (got[0], got[1], got[3]), (want[0], want[1], want[3])
    else:
        if fn == "hard":
            got = nms.static_nms(_t(bx)[None], _t(sc), 0.5, 0.05, top_k)
            one = lambda s: jax_nms.static_nms(bx, s, 0.5, 0.05, top_k)
        else:
            got = nms.soft_nms(_t(bx)[None], _t(sc), 0.5, 0.3, 0.05, top_k, fn)
            one = lambda s: jax_nms.soft_nms(bx, s, 0.5, 0.3, 0.05, top_k, fn)
        want = [np.stack(x) for x in zip(*[_np(one(s)) for s in sc])]
    (gb, gs, gv), (wb, ws, wv) = got, want
    assert gb.shape[-2] == top_k * (sc.shape[0] if fn == "class" else 1)
    assert gv.dtype == torch.bool
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0, atol=1e-6)
    assert np.asarray(wv).any()
    if fn in ("hard", "class"):
        assert not np.asarray(wv).all()  # something was suppressed


# ------------------------------------------------------------------ focal loss


def test_focal_loss_matches_jax():
    rng = np.random.default_rng(0)
    anchors = boxes.build_anchors((H, W))
    ann = _annotations()
    B, A = ann.shape[0], anchors.shape[0]
    cls = rng.uniform(0, 1, (B, A, C)).astype(np.float32)
    cls[0, :5] = 0.0  # clipped to 1e-4
    reg = rng.normal(0, 0.3, (B, A, 4)).astype(np.float32)

    def jloss(c, r):
        ld = jax_focal_loss(c, r, jnp.asarray(anchors), jnp.asarray(ann))
        return ld["total"], ld

    (_, jld), (jgc, jgr) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        cls, reg)
    tc, tr = _t(cls).requires_grad_(True), _t(reg).requires_grad_(True)
    ld = focal_loss(tc, tr, _t(anchors), _t(ann))
    ld["total"].backward()
    for k in ("classification", "regression", "total"):
        np.testing.assert_allclose(ld[k].item(), float(jld[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jgc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jgr), rtol=0, atol=1e-5)
    # the cases are there: positives in images 0 and 3, the ignore band in image 1
    iou = boxes.box_iou(_t(anchors), _t(ann[1, :1, :4]))[:, 0]
    assert ((iou >= 0.4) & (iou < 0.5)).any()
    assert float(jld["regression"]) > 0
    # image 2 alone (no boxes): every anchor negative, no regression
    one = focal_loss(_t(cls[2:3]), _t(reg[2:3]), _t(anchors), _t(ann[2:3]))
    assert one["regression"].item() == 0.0 and one["classification"].item() > 0


# ------------------------------------------------------------------ backbone taps


@pytest.mark.parametrize("variant", ["b0", "b2", "b5"])
def test_detector_tap_indices_match_jax(variant):
    taps = efficientnet.default_detector_taps(variant)
    assert taps == jax_efficientnet.default_detector_taps(variant)
    assert efficientnet.tap_channels(variant, taps) == \
        jax_efficientnet.tap_channels(variant, taps)
    assert taps == {"b0": (10, 15), "b2": (15, 21), "b5": (26, 37)}[variant]


def test_b0_taps_match_jax(jax_det, port_det):
    with torch.no_grad():
        taps = port_det.image_encoder(_t(jax_det["x"]))["taps"]
    assert len(taps) == len(jax_det["taps"]) == 2
    for got, want in zip(taps, jax_det["taps"]):
        assert tuple(got.shape) == want.shape  # NHWC
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# ------------------------------------------------------------------ RetinaNet


def test_retinanet_forward_matches_jax(jax_det, port_det):
    with torch.no_grad():
        out = port_det(_t(jax_det["x"]))
    A = boxes.build_anchors((H, W)).shape[0]
    assert out["class_probs"].shape == (N, A, C) and out["box_deltas"].shape == (N, A, 4)
    assert out["class_probs"].dtype == torch.float32
    for k in ("class_probs", "box_deltas"):
        np.testing.assert_allclose(out[k].numpy(), jax_det["out"][k], rtol=0, atol=1e-5,
                                   err_msg=k)
    probs = jax_det["out"]["class_probs"]
    assert probs.min() < 0.05 and probs.max() > 0.9  # spread: the slates below have content


def test_heads_init_like_flax():
    """init_heads: the prior bias on the class output, zero biases, lecun-normal
    kernels (truncated at 2 sigma, standard deviation sqrt(1 / fan_in))."""
    model = retinanet.RetinaNet(ENC, C)
    retinanet.init_heads(model, torch.Generator().manual_seed(0))
    bias = model.class_subnet.out.bias.detach().numpy()
    np.testing.assert_allclose(bias, -np.log(0.99 / 0.01), rtol=1e-6)
    assert float(model.box_subnet.out.bias.detach().abs().max()) == 0.0
    for kernel in (model.fpn.p4_out.kernel, model.fpn.p3_lateral.kernel,
                   model.class_subnet.conv2.kernel):
        k = kernel.detach().numpy()
        fan_in = k.shape[1] * k.shape[2] * k.shape[3]
        np.testing.assert_allclose(k.std(), np.sqrt(1.0 / fan_in), rtol=0.03)
        assert np.abs(k).max() <= 2.0 * np.sqrt(1.0 / fan_in) / 0.8796256610342398 + 1e-7


def _detect_both(jax_det, **kw):
    anchors = boxes.build_anchors((H, W))
    out = jax_det["out"]
    got = retinanet.detect({k: _t(v) for k, v in out.items()}, _t(anchors), (H, W), **kw)
    want = _np(jax_retinanet.detect({k: jnp.asarray(v) for k, v in out.items()},
                                    jnp.asarray(anchors), (H, W), **kw))
    return got, want


@pytest.mark.parametrize("mode", ["hard", "soft"])
def test_detect_matches_jax(jax_det, mode):
    got, want = _detect_both(jax_det, nms=mode, score_threshold=0.3)
    assert got["boxes"].shape == (N, C * 100, 4)
    for k in ("valid", "classes"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], rtol=0, atol=1e-6)
    assert want["valid"].sum() > 10


def test_detect_multiscale_single_scale_is_detect(jax_det):
    out = {k: _t(v) for k, v in jax_det["out"].items()}
    d1 = retinanet.detect(out, _t(boxes.build_anchors((H, W))), (H, W), score_threshold=0.3)
    d2 = retinanet.detect_multiscale(lambda imgs: out, _t(jax_det["x"]), (1.0,),
                                     score_threshold=0.3)
    for k in d1:
        np.testing.assert_array_equal(d1[k].numpy(), d2[k].numpy(), err_msg=k)


@pytest.mark.parametrize("mode", ["hard", "soft"])
def test_detect_multiscale_matches_jax(jax_det, port_det, mode):
    """Base 96x96 at (0.75, 1.0): 0.75 resizes to 64x64 (an antialiased
    shrink). Each side runs its own model, so near-equal scores may trade
    places: every valid detection is matched to one of the other side's of
    the same class within 1e-4 in score and 1e-3 px in box."""
    x = np.random.default_rng(2).standard_normal((N, 96, 96, 1)).astype(np.float32)
    small = retinanet.resize_bilinear(_t(x), (64, 64)).numpy()
    np.testing.assert_allclose(small, np.asarray(jax.image.resize(x, (N, 64, 64, 1),
                                                                  "bilinear")),
                               rtol=0, atol=1e-5)
    big = retinanet.resize_bilinear(_t(small), (96, 96)).numpy()
    np.testing.assert_allclose(big, np.asarray(jax.image.resize(small, (N, 96, 96, 1),
                                                                "bilinear")),
                               rtol=0, atol=1e-5)
    kw = dict(score_threshold=0.3, nms=mode)
    want = _np(jax_retinanet.detect_multiscale(
        lambda imgs: jax_det["fwd"](jax_det["v"], imgs)[0], jnp.asarray(x), (0.75, 1.0), **kw))
    with torch.no_grad():
        got = retinanet.detect_multiscale(lambda imgs: port_det(imgs), _t(x), (0.75, 1.0), **kw)
    got = {k: v.numpy() for k, v in got.items()}
    assert got["valid"].sum() == want["valid"].sum() > 10
    for i in range(N):
        mine = [(c, s, b) for c, s, b, v in zip(got["classes"][i], got["scores"][i],
                                                got["boxes"][i], got["valid"][i]) if v]
        for c, s, b, v in zip(want["classes"][i], want["scores"][i], want["boxes"][i],
                              want["valid"][i]):
            if v:
                assert any(c == c2 and abs(s - s2) <= 1e-4 and np.abs(b - b2).max() <= 1e-3
                           for c2, s2, b2 in mine), (i, c, s, b)


# ------------------------------------------------------------------ augmentation


def test_augment_with_boxes_on_jax_draws():
    rng = np.random.default_rng(3)
    B, h, w = 4, 64, 48
    imgs = rng.integers(0, 256, (B, h, w, 1)).astype(np.uint8)
    ann = -np.ones((B, 5, 5), np.float32)
    ann[:, 0] = [4, 6, 30, 40, 1]
    ann[:2, 1] = [20, 30, 44, 60, 0]
    jcfg = jax_aug.AugmentConfig(affine_p=1.0, elastic_p=1.0)
    key = jax.random.PRNGKey(7)
    jboxes = jax.jit(lambda i, a: jax_aug.augment_batch_with_boxes(
        i, a, key, jcfg, MEAN, STD)[1])(jnp.asarray(imgs), jnp.asarray(ann))
    k_aff, k_el = jax.random.split(key)  # the draws inside the JAX function
    mats, low = _np(jax.jit(lambda: (jax_aug.sample_affine_matrices(k_aff, B, h, w, jcfg),
                                     jax_aug.sample_elastic_lowres(k_el, B, h, w, jcfg)))())
    cfg = augment.AugmentConfig(affine_p=1.0, elastic_p=1.0)
    pimgs, pboxes = augment.augment_batch_with_boxes(_t(imgs), _t(ann), None, cfg, MEAN, STD,
                                                     matrices=_t(mats), lowres=_t(low))
    np.testing.assert_allclose(pboxes.numpy(), np.asarray(jboxes), rtol=0, atol=1e-4)
    assert (pboxes.numpy()[2:, 1] == -1).all()  # padded rows stay padded
    moved = np.abs(pboxes.numpy()[:, 0, :4] - ann[:, 0, :4]).max()
    assert moved > 1.0  # the transform did act on the boxes
    # the image: the port's single gather against the JAX package's at the same coordinates
    bg = (0.0 - MEAN) / STD

    @jax.jit
    def reference(imgs, mats, low):
        x = jax_aug.minmax_standardize(imgs, MEAN, STD)
        coords = jax_aug.affine_grid(mats, h, w) + jax.image.resize(low, (B, h, w, 2),
                                                                    "bilinear")
        return x, jax_aug.warp_bilinear(x - bg, coords) + bg

    x, want = reference(imgs, mats, low)
    np.testing.assert_allclose(pimgs.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    # eval: normalization only, boxes untouched
    e_imgs, e_boxes = augment.augment_batch_with_boxes(_t(imgs), _t(ann), None, cfg, MEAN, STD,
                                                       train=False)
    np.testing.assert_array_equal(e_boxes.numpy(), ann)
    np.testing.assert_allclose(e_imgs.numpy(), np.asarray(x), rtol=1e-6, atol=1e-6)


def test_augment_with_boxes_draws_from_the_generator():
    imgs = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (3, 32, 32, 1)))
    ann = torch.tensor([[[4.0, 6, 20, 24, 1]]] * 3)
    cfg = augment.AugmentConfig()
    a = augment.augment_batch_with_boxes(imgs, ann, torch.Generator().manual_seed(1), cfg, MEAN,
                                         STD)
    b = augment.augment_batch_with_boxes(imgs, ann, torch.Generator().manual_seed(1), cfg, MEAN,
                                         STD)
    c = augment.augment_batch_with_boxes(imgs, ann, torch.Generator().manual_seed(2), cfg, MEAN,
                                         STD)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[1], c[1])
    assert (a[1][..., :4] >= 0).all() and (a[1][..., [0, 2]] <= 31).all()


# ------------------------------------------------------------------ train steps


def _train_batches():
    ann = _annotations()
    rng = np.random.default_rng(9)
    return [{"images": rng.integers(0, 256, (N, H, W, 1)).astype(np.uint8),
             "annotations": ann[2 * i: 2 * i + 2]} for i in range(2)]


def test_detector_train_steps_match_jax(jax_det):
    anchors = boxes.build_anchors((H, W))
    batches = _train_batches()
    jpre = lambda b, rng: {**b, "images": jax_aug.minmax_standardize(b["images"], MEAN, STD)}
    tx = jax_build_optimizer(STEP_OPT, lambda s: LR)
    v = jax_det["init"]
    jstate = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=v["params"],
                           batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]), tx=tx)
    jtrain, _, _ = jax_experiments.make_detector_steps(jax_det["model"], anchors, jpre)

    model = retinanet.RetinaNet(ENC, C)
    load_jax_variables(model, v)
    before = {k: b.clone() for k, b in model.named_buffers()}
    state = create_train_state(model, build_optimizer(STEP_OPT, lambda s: LR,
                                                      model.named_parameters()))
    pre = lambda b, g: {**b, "images": augment.minmax_standardize(b["images"], MEAN, STD)}
    train_step, infer_step, _ = make_detector_steps(model, anchors, pre)
    for i, b in enumerate(batches):
        jstate, jld = jtrain(jstate, jax.tree_util.tree_map(jnp.asarray, b),
                             jax.random.PRNGKey(1))
        state, ld = train_step(state, {k: _t(x) for k, x in b.items()},
                               torch.Generator(), seed=0)
        for k in ("classification", "regression", "total"):
            np.testing.assert_allclose(ld[k].item(), float(jld[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i}: {k}")
        want = state_dict_from_jax({"params": _np(jstate.params)})
        got = model.state_dict()
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=1e-5,
                                       err_msg=f"step {i}: {k}")
        # the eval-mode backbone leaves its running statistics as they were
        for k, b0 in before.items():
            assert torch.equal(model.get_buffer(k), b0), k
        for k, b0 in state_dict_from_jax({"batch_stats": _np(jstate.batch_stats)}).items():
            np.testing.assert_array_equal(b0.numpy(), before[k].numpy())
    assert state.step == 2
    moved = np.abs(got["fpn.p3_out.kernel"].numpy()
                   - state_dict_from_jax({"params": v["params"]})["fpn.p3_out.kernel"].numpy())
    assert moved.max() > 1e-4  # the steps did move the weights
    out = infer_step(state, {k: _t(x) for k, x in batches[0].items()})
    assert out["class_probs"].shape == (N, anchors.shape[0], C)


def test_frozen_backbone_takes_no_gradient():
    model = retinanet.RetinaNet(ENC, C, freeze_backbone=True)
    retinanet.init_heads(model, torch.Generator().manual_seed(0))
    out = model(torch.randn(1, H, W, 1))
    (out["class_probs"].sum() + out["box_deltas"].sum()).backward()
    assert all(p.grad is None for p in model.image_encoder.parameters())
    assert model.fpn.p7.kernel.grad is not None


# ------------------------------------------------------------------ mAP


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_map_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n_img, n_cls, K = 6, 4, 20
    dets, anns = [], []
    for _ in range(n_img):
        m = int(rng.integers(0, 4))
        ann = -np.ones((5, 5), np.float32)
        xy = rng.uniform(0, 50, (m, 2))
        ann[:m, :2], ann[:m, 2:4] = xy, xy + rng.uniform(5, 20, (m, 2))
        ann[:m, 4] = rng.integers(0, n_cls, m)
        anns.append(ann)
        src = ann[rng.integers(0, max(m, 1), K), :4] if m else rng.uniform(0, 60, (K, 4))
        bx = (src + rng.normal(0, 2, (K, 4))).astype(np.float32)
        dets.append({"boxes": bx, "scores": rng.uniform(0, 1, K).astype(np.float32),
                     "classes": rng.integers(0, n_cls, K), "valid": rng.random(K) < 0.7})
    names = detect_eval.VINDR_DETECTION_CLASSES[:n_cls - 1] + ["No Finding"]
    for kw in ({}, {"class_names": names}, {"score_threshold": 0.4, "iou_threshold": 0.3}):
        got = detect_eval.evaluate_map(dets, anns, n_cls, **kw)
        assert got == jax_detect_eval.evaluate_map(dets, anns, n_cls, **kw)
    assert detect_eval.VINDR_DETECTION_CLASSES == jax_detect_eval.VINDR_DETECTION_CLASSES
