"""The port's training augmentation (``mies_tpu_torch.models.augment``)
against the JAX package's (``mies_tpu.models.augment``).

``jax.random``'s streams have no PyTorch counterpart, so each transform is
held by its application given the reference's own draws:

* ``dihedral`` for all 8 codes on a square slice and the 4 shape-keeping
  codes on a non-square one: bit-equal to ``_dihedral`` (pure
  permutations);
* ``apply_photometric`` given the factors and noise ``_photometric`` draws
  from its key (split as the reference splits it): within 1e-6 (the image
  mean's reduction order, and jnp.power against torch.pow);
* ``elastic_fields`` given the coarse noise ``_elastic_fields`` draws:
  within 2e-5 px at a 4 px amplitude (the jitted jax.image.resize the port
  holds to 4e-6 relative, tests/test_torch_geometry.py);
* ``elastic_warp`` given a field: within 1e-6 of the jitted
  map_coordinates(order=1, mode='nearest') (an FMA here and there).

The draws are checked by their distribution; ``augment_pair`` moves both
members alike.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mies_tpu.models import augment as JA
from mies_tpu_torch.models import augment as TA

torch.set_num_threads(2)


def _img(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("shape,codes", [((12, 12), range(8)),
                                         ((10, 14), (0, 1, 4, 5))])
def test_dihedral_equals_the_references(shape, codes):
    img = _img(shape)
    batch = torch.from_numpy(np.stack([img] * len(codes)))
    got = TA.apply_dihedral(batch, torch.tensor(list(codes)))
    for i, code in enumerate(codes):
        want = np.asarray(JA._dihedral(jnp.asarray(img), jnp.int32(code)))
        np.testing.assert_array_equal(got[i].numpy(), want)
        np.testing.assert_array_equal(TA.dihedral(batch[i], code).numpy(),
                                      want)
    if shape[0] != shape[1]:
        with pytest.raises(ValueError, match="non-square"):
            TA.apply_dihedral(batch[:1], torch.tensor([2]))


def _jax_photometric_draws(key, shape, cfg) -> dict:
    """The factors ``_photometric`` draws from ``key``, as it draws them."""
    n = shape[0]
    per_img = (n,) + (1,) * (len(shape) - 1)
    kb, kc, kg, kn = jax.random.split(key, 4)
    draws = {}
    if cfg.contrast > 0.0:
        draws["contrast"] = jax.random.uniform(
            kc, per_img, minval=1.0 - cfg.contrast, maxval=1.0 + cfg.contrast)
    if cfg.brightness > 0.0:
        draws["brightness"] = jax.random.uniform(
            kb, per_img, minval=-cfg.brightness, maxval=cfg.brightness)
    if cfg.gamma > 0.0:
        draws["gamma"] = jnp.exp(jax.random.uniform(
            kg, per_img, minval=-cfg.gamma, maxval=cfg.gamma))
    if cfg.noise_sigma > 0.0:
        draws["noise"] = jax.random.normal(kn, shape)
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("cfg", [
    TA.AugmentConfig(brightness=0.05, contrast=0.1, gamma=0.1),
    TA.AugmentConfig(brightness=0.3, contrast=0.5, gamma=0.4, noise_sigma=0.05),
    TA.AugmentConfig(brightness=0.3, contrast=0.5, noise_sigma=0.05, clip=False),
], ids=["default-recipe", "strong-with-noise", "no-clip"])
def test_photometric_given_its_factors_equals_the_references(cfg):
    x = _img((4, 16, 20), 1)
    key = jax.random.PRNGKey(5)
    jcfg = JA.AugmentConfig(**{f: getattr(cfg, f) for f in
                               cfg.__dataclass_fields__})
    want = np.asarray(JA._photometric(key, jnp.asarray(x), jcfg))
    draws = _jax_photometric_draws(key, x.shape, cfg)
    got = TA.apply_photometric(torch.from_numpy(x), draws, cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if cfg.clip:
        assert got.min() >= 0.0 and got.max() <= 1.0


def test_elastic_fields_given_the_coarse_noise_equal_the_references():
    cfg = TA.AugmentConfig(elastic=4.0, elastic_sigma=8.0)
    key = jax.random.PRNGKey(3)
    for hw in ((32, 32), (30, 45)):
        want = np.asarray(JA._elastic_fields(key, 3, hw, cfg))
        s = max(2, int(cfg.elastic_sigma) // 2)
        raw = jax.random.normal(key, (3, 2, max(2, hw[0] // s),
                                      max(2, hw[1] // s)))
        got = TA.elastic_fields(torch.from_numpy(np.array(raw)), hw, cfg)
        assert got.shape == (3, 2, *hw)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
        peak = got.abs().amax(dim=(1, 2, 3))
        torch.testing.assert_close(peak, torch.full((3,), 4.0))


def test_elastic_warp_given_a_field_equals_the_references():
    """[B, 1, H, W] here, [B, H, W, 1] in the reference: the same samples,
    with displacements past every edge."""
    rng = np.random.default_rng(4)
    imgs = _img((3, 24, 30), 2)
    fields = (rng.standard_normal((3, 2, 24, 30)) * 5.0).astype(np.float32)
    want = np.asarray(jax.vmap(JA._elastic_warp)(jnp.asarray(imgs[..., None]),
                                                 jnp.asarray(fields)))[..., 0]
    got = TA.elastic_warp(torch.from_numpy(imgs[:, None]),
                          torch.from_numpy(fields))[:, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    zero = TA.elastic_warp(torch.from_numpy(imgs), torch.zeros(3, 2, 24, 30))
    assert torch.equal(zero, torch.from_numpy(imgs))


def test_geometric_draws_by_their_distribution():
    """P(hflip) = P(vflip) = 0.5 with rotations: the 8 codes uniform (each
    within 5 sigma of n/8); non-square: only {0, 1, 4, 5}, uniform; all
    off: the identity."""
    n = 8000
    gen = torch.Generator().manual_seed(0)
    codes = TA.draw_geometric(gen, n, TA.AugmentConfig(), square=True)
    counts = torch.bincount(codes, minlength=8).numpy()
    sigma = np.sqrt(n * (1 / 8) * (7 / 8))
    assert np.all(np.abs(counts - n / 8) < 5 * sigma), counts
    codes = TA.draw_geometric(gen, n, TA.AugmentConfig(), square=False)
    counts = torch.bincount(codes, minlength=8).numpy()
    assert set(np.flatnonzero(counts)) == {0, 1, 4, 5}
    sigma = np.sqrt(n * (1 / 4) * (3 / 4))
    assert np.all(np.abs(counts[[0, 1, 4, 5]] - n / 4) < 5 * sigma), counts
    off = TA.AugmentConfig(hflip=0.0, vflip=0.0, rot90=False)
    assert not TA.draw_geometric(gen, 100, off, square=True).any()


def test_photometric_and_elastic_draws_by_their_distribution():
    gen = torch.Generator().manual_seed(1)
    cfg = TA.AugmentConfig(brightness=0.2, contrast=0.3, gamma=0.4,
                           noise_sigma=0.1)
    d = TA.draw_photometric(gen, (4000, 1, 8, 8), cfg)
    assert d["contrast"].shape == (4000, 1, 1, 1)
    for name, lo, hi in (("contrast", 0.7, 1.3), ("brightness", -0.2, 0.2)):
        v = d[name].ravel()
        assert v.min() >= lo and v.max() <= hi
        assert abs(v.mean().item() - (lo + hi) / 2) < 0.01
        assert abs(v.std().item() - (hi - lo) / np.sqrt(12)) < 0.01
    lg = torch.log(d["gamma"]).ravel()  # log-uniform in [-0.4, 0.4]
    assert lg.min() >= -0.4 - 1e-6 and lg.max() <= 0.4 + 1e-6
    assert abs(lg.mean().item()) < 0.01
    z = d["noise"]
    assert z.shape == (4000, 1, 8, 8) and abs(z.std().item() - 1.0) < 0.01
    assert set(TA.draw_photometric(gen, (4, 8, 8), TA.AugmentConfig())) == set()
    raw = TA.draw_elastic(gen, 500, (64, 40),
                          TA.AugmentConfig(elastic=3.0, elastic_sigma=8.0))
    assert raw.shape == (500, 2, 16, 10) and abs(raw.std().item() - 1) < 0.01


def test_augment_pair_moves_both_members_alike():
    """Geometry and warp on both members, photometric on the noisy one:
    with the photometric off, (x, x) stays a pair of equals; with it on,
    the clean member is the noisy one's geometry alone."""
    x = torch.from_numpy(_img((6, 1, 16, 16), 3))
    geo = TA.AugmentConfig(elastic=3.0)
    a, b = TA.augment_pair(torch.Generator().manual_seed(2), x, x.clone(), geo)
    assert torch.equal(a, b) and not torch.equal(a, x)
    full = TA.AugmentConfig(brightness=0.1, contrast=0.2, gamma=0.2,
                            elastic=3.0)
    n, c = TA.augment_pair(torch.Generator().manual_seed(2), x, x.clone(),
                           full)
    assert torch.equal(c, b) and not torch.equal(n, c)
    one = TA.augment_batch(torch.Generator().manual_seed(2), x, geo)
    assert torch.equal(one, a)
