"""The port's augmentation (mammo_clip_tpu_torch/ops/augment.py) against the
JAX package's ``ops/augment.py``.

Deterministic pieces (normalization, the grid, the bilinear warp, the elastic
upsample, the composed warp) are fed the same inputs on both sides and agree
to 1e-4 (fp32, coordinates up to ~100 px). The samplers draw from a
``torch.Generator``, so they are checked statistically, as
tests/test_augment.py checks the JAX ones: flip and gate frequencies within
4.5 binomial standard deviations of p, and the scale and rotation ranges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mammo_clip_tpu.ops import augment as jax_aug
from mammo_clip_tpu_torch.ops import augment


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """1 intra-op thread: the suite runs its files in parallel
    processes, and torch's default of one thread per core in each oversubscribes
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


CFG = augment.AugmentConfig()
JCFG = jax_aug.AugmentConfig()


def test_minmax_standardize_matches_jax():
    x = np.random.default_rng(0).integers(0, 256, size=(3, 20, 12, 1)).astype(np.uint8)
    np.testing.assert_allclose(augment.minmax_standardize(torch.from_numpy(x), 0.3, 0.25).numpy(),
                               np.asarray(jax_aug.minmax_standardize(jnp.asarray(x), 0.3, 0.25)),
                               rtol=1e-6, atol=1e-6)


def test_warp_with_given_matrices_and_field_matches_jax():
    rng = np.random.default_rng(1)
    h, w = 40, 24
    x = rng.standard_normal((4, h, w, 1)).astype(np.float32)
    mats = np.asarray(jax_aug.sample_affine_matrices(jax.random.PRNGKey(2), 4, h, w, JCFG))
    low = np.asarray(jax_aug.sample_elastic_lowres(jax.random.PRNGKey(3), 4, h, w,
                                                   jax_aug.AugmentConfig(elastic_p=1.0)))
    disp = np.asarray(jax.image.resize(jnp.asarray(low), (4, h, w, 2), method="bilinear"))
    np.testing.assert_allclose(augment.upsample_displacement(torch.from_numpy(low), h, w).numpy(),
                               disp, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(augment.affine_grid(torch.from_numpy(mats), h, w).numpy(),
                               np.asarray(jax_aug.affine_grid(jnp.asarray(mats), h, w)),
                               rtol=1e-5, atol=1e-4)
    coords = np.asarray(jax_aug.affine_grid(jnp.asarray(mats), h, w)) + disp
    np.testing.assert_allclose(
        augment.warp_bilinear(torch.from_numpy(x), torch.from_numpy(coords)).numpy(),
        np.asarray(jax_aug.warp_bilinear(jnp.asarray(x), jnp.asarray(coords))),
        rtol=1e-4, atol=1e-4)
    bg = (0.0 - 0.3) / 0.25
    want = jax_aug.warp_bilinear(jnp.asarray(x) - bg, jnp.asarray(coords)) + bg
    got = augment.apply_warp(torch.from_numpy(x), torch.from_numpy(mats), torch.from_numpy(disp),
                             0.3, 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def _within(freq, p, n):
    return abs(freq - p) <= 4.5 * np.sqrt(p * (1 - p) / n)


def test_affine_sampling_statistics():
    n, h, w = 4000, 64, 32
    g = torch.Generator().manual_seed(0)
    m = augment.sample_affine_matrices(g, n, h, w, CFG).numpy().astype(np.float64)
    a = m[:, :, :2]
    fwd = np.linalg.inv(a)  # forward linear part; first column (sx cos r, sx sin r)
    sx = np.hypot(fwd[:, 0, 0], fwd[:, 1, 0])
    identity_like = np.isclose(np.abs(fwd[:, 0, 0]), 1.0) & np.isclose(fwd[:, 1, 0], 0.0) \
        & np.isclose(np.abs(fwd[:, 1, 1]), 1.0) & np.isclose(fwd[:, 0, 1], 0.0)
    assert _within(identity_like.mean(), 1 - CFG.affine_p, n)
    flips = fwd[identity_like]  # no affine drawn: pure flip matrices
    assert _within((flips[:, 0, 0] < 0).mean(), CFG.hflip_p, len(flips))
    assert _within((flips[:, 1, 1] < 0).mean(), CFG.vflip_p, len(flips))
    aff = fwd[~identity_like]
    assert sx.min() >= CFG.scale_min - 1e-4 and sx.max() <= CFG.scale_max + 1e-4
    s = np.sign(aff[:, 0, 0])  # |rotation| <= 20 deg, so cos > 0 and the sign is the flip
    rot = np.degrees(np.arctan2(aff[:, 1, 0] * s, aff[:, 0, 0] * s))
    assert np.abs(rot).max() <= CFG.rotate_deg + 1e-3
    assert np.abs(rot).max() >= 0.9 * CFG.rotate_deg  # the range is used, not just a corner


def test_elastic_sampling_statistics_match_jax():
    n, h, w = 512, 64, 48
    g = torch.Generator().manual_seed(1)
    low = augment.sample_elastic_lowres(g, n, h, w, CFG).numpy()
    jlow = np.asarray(jax_aug.sample_elastic_lowres(jax.random.PRNGKey(1), n, h, w, JCFG))
    assert low.shape == jlow.shape == (n, h // 8, w // 8, 2)
    on = np.abs(low).reshape(n, -1).max(axis=1) > 0
    assert _within(on.mean(), CFG.elastic_p, n)
    jon = np.abs(jlow).reshape(n, -1).max(axis=1) > 0
    # the same blur and amplitude: the gated-on fields' spread agrees within 5%
    np.testing.assert_allclose(low[on].std(), jlow[jon].std(), rtol=0.05)
    full = augment.sample_elastic_displacement(torch.Generator().manual_seed(2), 2, h, w, CFG)
    assert full.shape == (2, h, w, 2)


@pytest.mark.parametrize("train", [True, False])
def test_augment_two_views_shapes_and_background(train):
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.integers(0, 256, size=(3, 32, 16, 1)).astype(np.float32))
    views = torch.from_numpy(rng.integers(0, 256, size=(3, 32, 16, 1)).astype(np.float32))
    a, b = augment.augment_two_views(imgs, views, torch.Generator().manual_seed(0), CFG,
                                     0.3, 0.25, train=train)
    assert a.shape == b.shape == (3, 32, 16, 1) and a.dtype == torch.float32
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    lo, hi = (0.0 - 0.3) / 0.25, (1.0 - 0.3) / 0.25
    assert a.min() >= lo - 1e-5 and a.max() <= hi + 1e-5
    if not train:
        np.testing.assert_allclose(a.numpy(), augment.minmax_standardize(imgs, 0.3, 0.25).numpy())
