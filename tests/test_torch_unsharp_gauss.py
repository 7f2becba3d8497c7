"""The port's 1024^2 mammography chains: K7 (unsharp -> gaussian in one
kernel), the pairwise peephole that picks it, and K3 / K4 where the TPU
took its pre-padded kernels, against the JAX package on the CPU.

The plain versions are held against the TPU kernels they replace, run in
Pallas interpret mode (``unsharp_gauss_tpu``; ``bilateral_tpu`` and
``unsharp_quant_tpu`` with ``scratch_borders=False``, the path the TPU
takes where the scratch border misfits VMEM). XLA:CPU contracts the blur
passes into FMAs and the port does not, hence atol 1e-6, the bound the K4
test holds (tests/test_torch_kernels.py). The CUDA kernel runs only on the
card: those tests carry the ``cuda`` marker and skip without one.
"""

import numpy as np
import pytest
import torch
from pytest import skip

import mies_tpu_torch
from mies_tpu_torch.kernels import _build
from mies_tpu_torch.kernels import bilateral as KB
from mies_tpu_torch.kernels import unsharp_gauss as KU
from mies_tpu_torch.ops import filters as TF
from mies_tpu_torch.pipeline import compiler as TC
from mies_tpu_torch.pipeline.config import PipelineConfig

torch.set_num_threads(2)

MAMMOGRAM = "configs/mammogram_sharpen.yaml"
W3 = [("unsharp_mask", {"radius": 1.5, "amount": 1.0}),
      ("gaussian_blur", {"sigma": 1.5})]


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _levels_close(a: np.ndarray, b: np.ndarray) -> None:
    """<= 1 uint8 level on < 0.1% of pixels (XLA:CPU FMA rounding ties)."""
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


# --- K7 --------------------------------------------------------------------


def test_k7_plain_matches_pallas_unsharp_gauss(rng):
    import jax.numpy as jnp
    from mies_tpu.kernels.unsharp_gauss import unsharp_gauss_tpu

    x = rng.random((2, 128, 128)).astype(np.float32)
    ref = np.asarray(unsharp_gauss_tpu(jnp.asarray(x), 1.5, 1.0, 1.5,
                                       interpret=True))
    out = KU.unsharp_gauss_cuda(torch.from_numpy(x), 1.5, 1.0, 1.5).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape,radius,amount,sigma", [
    ((2, 128, 128), 1.5, 1.0, 1.5),
    ((1, 61, 83), 1.0, 0.7, 2.5),
    ((2, 5, 40), 2.0, 1.5, 0.5),   # shorter than the Gaussians' radii
])
def test_k7_plain_matches_jax_unfused_pair(rng, shape, radius, amount, sigma):
    import jax.numpy as jnp
    from mies_tpu.ops.filters import gaussian_blur, unsharp_mask

    x = rng.random(shape).astype(np.float32)
    ref = np.stack([np.asarray(gaussian_blur(
        unsharp_mask(jnp.asarray(s), radius, amount), sigma)) for s in x])
    out = KU.unsharp_gauss_cuda(torch.from_numpy(x), radius, amount,
                                sigma).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_k7_plain_is_the_port_pair_bit_for_bit(rng):
    x = torch.from_numpy(rng.random((2, 70, 45)).astype(np.float32))
    pair = TF.gaussian_blur(TF.unsharp_mask(x, 1.5, 1.0), 1.5)
    assert torch.equal(KU.unsharp_gauss_plain(x, 1.5, 1.0, 1.5), pair)


def test_k7_limits_are_shared_memory_and_taps():
    assert KU.unsharp_gauss_supported(1.5, 1.5)
    assert KU.unsharp_gauss_supported(4.0, 4.0)       # r 16 + 16
    assert not KU.unsharp_gauss_supported(1.5, 17.0)  # r2 68 > 64 taps
    assert not KU.unsharp_gauss_supported(12.0, 12.0)  # 227 KB exceeded
    assert not KU.unsharp_gauss_supported(1.5, 0.0)
    with pytest.raises(ValueError, match="shared memory"):
        KU.unsharp_gauss_cuda(torch.zeros(1, 64, 64), 12.0, 1.0, 12.0)
    with pytest.raises(TypeError):
        KU.unsharp_gauss_cuda(torch.zeros(1, 64, 64, dtype=torch.float64))


def test_k7_strip_fits_every_pair_it_takes():
    """The strip kernel's shared memory holds every radius pair K7 takes,
    and the set it takes is the first design's: 2,415 pairs of radii up to
    64, (35, 35) but not (36, 36), r2 up to 53 beside r1 = 0."""
    taken = [(a, b) for a in range(65) for b in range(65) if KU._accepted(a, b)]
    assert len(taken) == 2415
    assert (35, 35) in taken and (36, 36) not in taken
    assert (0, 53) in taken and (0, 54) not in taken and (64, 0) in taken
    assert max(KU.unsharp_gauss_smem(a, b) for a, b in taken) <= KU.UG_SMEM_MAX


@pytest.mark.parametrize("where", ["top-left", "inside", "bottom-right"])
@pytest.mark.parametrize("radius,sigma", [(2.0, 4.0), (3.0, 1.0)])
def test_k7_halo_is_r1_plus_r2(where, radius, sigma):
    """unsharp -> Gaussian reads r1 + r2 pixels around an output: the pair
    on the window of a tile with a halo of r1 + r2 (image edges where the
    window meets them) equals, on the tile, the pair on the whole slice;
    with r1 + r2 - 1 it does not. Truncate 1.5 (radii 3 and 6, 5 and 2)
    keeps the outermost taps heavy enough for float32 to show them."""
    x = torch.from_numpy(np.random.default_rng(7).random((1, 40, 52))
                         .astype(np.float32))
    trunc = 1.5
    halo = KU._tap_radius(radius, trunc) + KU._tap_radius(sigma, trunc)
    th, tw = 10, 12
    y0, x0 = {"top-left": (0, 0), "inside": (15, 20),
              "bottom-right": (40 - th, 52 - tw)}[where]
    whole = KU.unsharp_gauss_plain(x, radius, 1.7, sigma, trunc)[
        :, y0:y0 + th, x0:x0 + tw]

    def on_window(h):
        wy, wx = max(y0 - h, 0), max(x0 - h, 0)
        win = x[:, wy:min(y0 + th + h, 40), wx:min(x0 + tw + h, 52)]
        got = KU.unsharp_gauss_plain(win.contiguous(), radius, 1.7, sigma,
                                     trunc)
        return got[:, y0 - wy:y0 - wy + th, x0 - wx:x0 - wx + tw]

    assert torch.equal(on_window(halo), whole)
    if where == "inside":
        assert not torch.equal(on_window(halo - 1), whole)


# --- rows 21-22: K3 / K4 against the TPU's pre-padded kernels ---------------


def test_k3_plain_matches_pallas_prepadded_bilateral(rng):
    import jax.numpy as jnp
    from mies_tpu.kernels.bilateral import bilateral_tpu

    x = rng.random((2, 128, 128)).astype(np.float32)
    ref = np.asarray(bilateral_tpu(jnp.asarray(x), 5, 0.1, 1.5, "reflect",
                                   interpret=True, scratch_borders=False))
    out = KB.bilateral_cuda(torch.from_numpy(x), 5, 0.1, 1.5, "reflect")
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-6, rtol=0)


@pytest.mark.parametrize("quantize", [True, False])
def test_k4_plain_matches_pallas_prepadded_unsharp(rng, quantize):
    import jax.numpy as jnp
    from mies_tpu.kernels.unsharp_gauss import unsharp_quant_tpu

    x = rng.random((2, 128, 128)).astype(np.float32)
    ref = np.asarray(unsharp_quant_tpu(jnp.asarray(x), 1.5, 1.0,
                                       quantize=quantize, interpret=True,
                                       scratch_borders=False))
    out = KU.unsharp_quant_cuda(torch.from_numpy(x), 1.5, 1.0,
                                quantize=quantize).numpy()
    if quantize:
        _levels_close(out, ref)
    else:
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


# --- the chains and the peephole -------------------------------------------


def test_w3_chain_matches_jax(rng):
    import jax.numpy as jnp

    import mies_tpu
    from mies_tpu.pipeline.config import PipelineConfig as JaxConfig

    x = rng.random((2, 128, 128)).astype(np.float32)
    ref = np.asarray(mies_tpu.compile_pipeline(
        JaxConfig.make(W3), batched=True)(jnp.asarray(x)))
    _build.reset_launches()
    out = mies_tpu_torch.compile_pipeline(
        PipelineConfig.make(W3), batched=True, device="cpu")(x).numpy()
    assert out.dtype == np.uint8
    _levels_close(out, ref)
    assert _build.LAUNCHES == dict.fromkeys(_build.LAUNCHES, 0)


def test_mammogram_yaml_matches_jax_on_uint16(rng):
    import jax.numpy as jnp

    import mies_tpu

    x = rng.integers(0, 65536, (2, 128, 128)).astype(np.uint16)
    ref = np.asarray(mies_tpu.compile_pipeline(
        mies_tpu.load_config(MAMMOGRAM), batched=True)(jnp.asarray(x)))
    cfg = mies_tpu_torch.load_config(MAMMOGRAM)
    out = mies_tpu_torch.compile_pipeline(cfg, batched=True,
                                          device="cpu")(x).numpy()
    _levels_close(out, ref)
    assert cfg.to_dict() == mies_tpu.load_config(MAMMOGRAM).to_dict()


def test_peephole_picks_k7_for_w3_only():
    cfg = PipelineConfig.make(W3)
    stages, tail = TC._try_fuse_unsharp_quant(cfg, True)
    assert tail is None  # the chain ends in gaussian_blur: no K4
    (fused,) = TC._bind_stages(stages)
    assert fused.func is KU.unsharp_gauss_cuda
    assert fused.keywords == {"radius": 1.5, "amount": 1.0, "sigma": 1.5,
                              "truncate": 4.0}

    mammo = mies_tpu_torch.load_config(MAMMOGRAM)  # gaussian -> unsharp
    stages, tail = TC._try_fuse_unsharp_quant(mammo, True)
    assert tail.func is KU.unsharp_quant_cuda
    (blur,) = TC._bind_stages(stages)
    assert blur.func is TF.gaussian_blur
    assert all(fn.func is not KU.unsharp_gauss_cuda
               for fn in TC._bind_stages(mammo.stages))


@pytest.mark.parametrize("a,b", [
    ({"mode": "reflect"}, {}),
    ({"clip": False}, {}),
    ({}, {"mode": "mirror"}),
    ({}, {"truncate": 3.0}),
    ({"radius": 1.5}, {"sigma": 20.0}),  # beyond the kernel's taps
])
def test_peephole_leaves_other_pairs_unfused(a, b):
    pair = PipelineConfig.make([("unsharp_mask", {"radius": 1.0, **a}),
                                ("gaussian_blur", {"sigma": 1.0, **b})])
    assert TC._try_fuse_unsharp_gauss(*pair.stages) is None
    assert len(TC._bind_stages(pair.stages)) == 2


@pytest.mark.parametrize("sigma,mode", [(1.5, "nearest"), (1.0, "reflect")])
def test_fused_and_unfused_chains_agree(rng, sigma, mode):
    """Whether the pair fuses or not, the chain computes the same pair."""
    cfg = PipelineConfig.make([("unsharp_mask", {"radius": 1.5}),
                               ("gaussian_blur", {"sigma": sigma,
                                                  "mode": mode})])
    x = torch.from_numpy(rng.random((2, 64, 96)).astype(np.float32))
    out = TC.build_batched_chain(cfg, device="cpu")(x)
    assert torch.equal(out, TF.gaussian_blur(TF.unsharp_mask(x, 1.5), sigma,
                                             mode=mode))


# --- the kernel on the card -------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1024, 1024), (2, 251, 333), (1, 5, 40)])
@pytest.mark.parametrize("radius,sigma", [(1.5, 1.5), (1.0, 2.5), (3.0, 9.0)])
def test_k7_on_card_equals_plain(cuda_device, shape, radius, sigma):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.rand(shape, generator=g, device=cuda_device)
    _build.reset_launches()
    got = KU.unsharp_gauss_cuda(x, radius, 1.0, sigma)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["unsharp_gauss"] == 1
    assert torch.equal(got, KU.unsharp_gauss_plain(x, radius, 1.0, sigma))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1, 1), (2, 5, 7), (2, 31, 33),
                                   (1, 33, 1025), (2, 251, 333),
                                   (8, 1024, 1024)])
@pytest.mark.parametrize("radius,sigma", [
    (1.5, 1.5),    # r1 = r2 = 6: the compile-time radii (w3)
    (0.5, 3.0),    # r 2 and 12
    (4.0, 1.0),    # r 16 and 4
    (15.5, 5.0),   # r 62 and 20: the widest r1 + r2 K7 takes
])
@pytest.mark.parametrize("amount", [0.0, 2.5])
def test_k7_on_card_bit_equal(cuda_device, shape, radius, sigma, amount):
    """The strip kernel, at compile-time and at runtime radii: bit-equal to
    the plain pair at images smaller than the Gaussians, one column wide,
    one strip plus one column and at the w3 shape, one launch."""
    assert KU.unsharp_gauss_supported(radius, sigma)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.rand(shape, generator=g, device=cuda_device)
    _build.reset_launches()
    got = KU.unsharp_gauss_cuda(x, radius, amount, sigma)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["unsharp_gauss"] == 1
    assert torch.equal(got, KU.unsharp_gauss_plain(x, radius, amount, sigma))


@pytest.mark.cuda
def test_w3_and_mammogram_launch_their_kernels_once(cuda_device):
    x = torch.rand((2, 256, 256), device=cuda_device)
    for cfg, want in ((PipelineConfig.make(W3), {"unsharp_gauss": 1}),
                      (mies_tpu_torch.load_config(MAMMOGRAM),
                       {"unsharp_quant": 1})):
        _build.reset_launches()
        mies_tpu_torch.compile_pipeline(cfg, batched=True)(x)
        torch.cuda.synchronize()
        assert {k: v for k, v in _build.LAUNCHES.items() if v} == want
