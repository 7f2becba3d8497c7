"""The port's metric suite (``mies_tpu_torch.eval.metrics``) against the JAX
package on the CPU.

* Every entry of ``METRIC_REGISTRY`` against the JAX metric run op by op,
  at 64x96 and 67x93 (msssim at 176x190), on a float [0, 1] pair (max_val
  1), a uint8 pair, the identity pair and a constant ground truth. Bound:
  |port - jax| <= REL[name] * |jax| + ABS[name]. The window sums are
  separable float32 shifted adds where the reference runs an XLA
  convolution, so the sums differ by reduction order: 2e-6 relative; 5e-5
  where a windowed variance E[x^2] - mu^2 cancels (ssim, uqi, scc, vifp,
  msssim: on the constant image the zero variance is the roundoff of
  117^2, whose ulp is 1e-3, beside ssim's C2 = 58.5);
  sam's arccos turns the last ulp of a ratio near 1 into up to 3.5e-4 rad
  (abs 1e-3, tests/test_metrics.py's identity bound). vifp of a constant
  ground truth is 0/0 (the float64 golden gives nan): both packages return
  the float32 roundoff of a zero variance, so there the port is held to a
  finite value below 0.05 (ROADMAP.md queue 3). The JAX metric is jitted.
* The same metrics against tests/goldens/golden_metrics.py on
  tests/test_metrics.py's pair, within that file's bounds.
* ``evaluate`` (Python floats, the max_val routing) and
  ``evaluate_volume`` on [5, 64, 96] against the JAX package's.

The reports and the command line's eval side: tests/test_torch_eval_cli.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from mies_tpu.eval import metrics as J
from mies_tpu_torch.eval import metrics as T
from tests.goldens import golden_metrics as G

NAMES = tuple(J.METRIC_REGISTRY)
REL = {**dict.fromkeys(NAMES, 2e-6),
       **dict.fromkeys(("ssim", "uqi", "scc", "vifp", "msssim"), 5e-5)}
ABS = {**dict.fromkeys(NAMES, 1e-6), "sam": 1e-3}
torch.set_num_threads(2)


def _close(got: float, want: float, name: str, what: str = "") -> None:
    if np.isinf(want) or np.isinf(got):
        assert got == want, (name, what, got, want)
        return
    assert abs(got - want) <= REL[name] * abs(want) + ABS[name], (
        name, what, got, want)


def _pairs(shape, seed=3):
    """(kind, gt, p, max_val) for the four kinds of pair."""
    rng = np.random.default_rng(seed)
    gt = (rng.random(shape) * 255).astype(np.float32)
    p = np.clip(ndimage.gaussian_filter(gt, 1.2) + rng.normal(0, 6, shape),
                0, 255).astype(np.float32)
    return [
        ("float01", gt / 255, p / 255, 1.0),
        ("uint8", gt.astype(np.uint8), p.astype(np.uint8), 255.0),
        ("identity", p, p, 255.0),
        ("constant", np.full(shape, 117.0, np.float32), p, 255.0),
    ]


def _call(mod, name, gt, p, max_val):
    kw = {"max_val": max_val} if name in T.MAX_VAL_METRICS else {}
    return mod.METRIC_REGISTRY[name](gt, p, **kw)


CASES = [(n, s) for n in NAMES if n != "msssim" for s in ((64, 96), (67, 93))]
CASES += [("msssim", (176, 190))]


@pytest.mark.parametrize("name,shape", CASES,
                         ids=[f"{n}-{s[0]}x{s[1]}" for n, s in CASES])
def test_metric_matches_the_jax_metric(name, shape):
    jitted = jax.jit(functools.partial(_call, J, name),
                     static_argnames=("max_val",))
    for kind, gt, p, mv in _pairs(shape):
        want = float(jitted(jnp.asarray(gt), jnp.asarray(p), max_val=mv))
        got = _call(T, name, torch.from_numpy(gt), torch.from_numpy(p), mv)
        assert got.shape == () and got.dtype == torch.float32
        if name == "vifp" and kind == "constant":
            assert np.isfinite(float(got)) and abs(float(got)) < 0.05
            continue
        _close(float(got), want, name, kind)


@pytest.fixture(scope="module")
def golden_pair():
    """tests/test_metrics.py's pair: 192x192, blur + noise."""
    rng = np.random.default_rng(3)
    gt = (rng.random((192, 192)) * 255).astype(np.float32)
    p = ndimage.gaussian_filter(gt, 1.2) + rng.normal(0, 6, gt.shape)
    return gt, np.clip(p, 0, 255).astype(np.float32)


# tests/test_metrics.py PAIRS' bounds (rel and abs alike)
GOLDEN_TOL = {"mse": 1e-3, "rmse": 1e-4, "psnr": 1e-4, "uqi": 1e-4,
              "ssim": 1e-4, "msssim": 1e-3, "ergas": 1e-2, "scc": 5e-3,
              "scc_global": 1e-4, "rase": 1e-2, "sam": 1e-4, "vifp": 1e-3,
              "psnrb": 1e-4}


@pytest.mark.parametrize("name", NAMES)
def test_metric_matches_golden(golden_pair, name):
    gt, p = golden_pair
    ours = float(T.METRIC_REGISTRY[name](torch.from_numpy(gt),
                                         torch.from_numpy(p)))
    ref = getattr(G, name)(gt, p)
    tol = GOLDEN_TOL[name]
    assert ours == pytest.approx(ref, rel=tol, abs=tol), (name, ours, ref)


def test_a_batch_is_its_images(golden_pair):
    """[3, H, W] gives each image's value (the reference's vmap), within
    the reduction order of a batched sum (ABS; image 1 is an identity
    pair, where sam's arccos amplifies an ulp)."""
    gt, p = golden_pair
    b_gt = torch.from_numpy(np.stack([gt, p, gt[::-1].copy()]))
    b_p = torch.from_numpy(np.stack([p, p, gt]))
    for name in NAMES:
        got = T.METRIC_REGISTRY[name](b_gt, b_p)
        assert got.shape == (3,)
        for i in range(3):
            one = T.METRIC_REGISTRY[name](b_gt[i], b_p[i])
            torch.testing.assert_close(got[i], one, rtol=1e-6,
                                       atol=ABS[name], msg=name)


def test_evaluate_equals_the_jax_evaluate(golden_pair):
    """All 13 names in one call, Python floats, max_val routed to psnr,
    ssim, msssim and psnrb only."""
    gt, p = golden_pair
    for mv in (100.0,):
        want = J.evaluate(gt, p, names=NAMES, max_val=mv)
        got = T.evaluate(gt, p, names=NAMES, max_val=mv, device="cpu")
        assert list(got) == sorted(NAMES) == list(want)
        assert all(type(v) is float for v in got.values())
        for k in NAMES:
            _close(got[k], want[k], k)
    with pytest.raises(ValueError, match="unknown metric"):
        T.evaluate(gt, p, names=("psnr", "lpips"), device="cpu")


def test_msssim_refuses_below_ws_times_16():
    x = torch.zeros((175, 200))
    with pytest.raises(ValueError, match="msssim needs min"):
        T.msssim(x, x)


def test_evaluate_volume_equals_the_jax_evaluate_volume():
    rng = np.random.default_rng(11)
    gt = (rng.random((5, 64, 96)) * 255).astype(np.float32)
    p = np.clip(gt + rng.normal(0, 8, gt.shape), 0, 255).astype(np.float32)
    p[2] = gt[2]  # an identical slice: psnr inf
    names = ("psnr", "ssim", "uqi", "vifp", "rmse")
    want = J.evaluate_volume(gt, p, names=names)
    got = T.evaluate_volume(gt, p, names=names, device="cpu")
    assert set(got) == {"mean", "per_slice"}
    assert np.isinf(got["per_slice"]["psnr"][2]) and np.isinf(got["mean"]["psnr"])
    for k in names:
        assert len(got["per_slice"][k]) == 5
        for a, b in zip(got["per_slice"][k], want["per_slice"][k]):
            _close(a, b, k)
        _close(got["mean"][k], want["mean"][k], k)


def test_entry_points_need_the_card_by_default():
    if torch.cuda.is_available():
        return
    x = np.zeros((16, 16), np.float32)
    with pytest.raises(RuntimeError, match="is_available"):
        T.evaluate(x, x)
    with pytest.raises(RuntimeError, match="is_available"):
        T.evaluate_volume(x[None], x[None])
