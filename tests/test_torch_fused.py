"""The fused bilateral -> unsharp -> uint8 tail (K13, mies_tpu_torch.kernels
.fused) and its switch MIES_TPU_FUSE_TAIL.

On the CPU the wrapper runs its plain version (the plain bilateral, then
unsharp_mask('nearest'), then the quantize), held here against the TPU
kernel it replaces, ``bilateral_unsharp_tpu`` in Pallas interpret mode, at
tests/test_kernels.py's tolerances. K13 itself runs only on the card: those
tests carry the ``cuda`` marker and skip here.
"""

import numpy as np
import pytest
import torch
from pytest import skip

from mies_tpu_torch.kernels import _build
from mies_tpu_torch.kernels import bilateral as KB
from mies_tpu_torch.kernels import fused as KF
from mies_tpu_torch.kernels import unsharp_gauss as KU
from mies_tpu_torch.pipeline import compiler as C
from mies_tpu_torch.pipeline.config import PipelineConfig
from mies_tpu_torch.pipeline.presets import flagship_config

TAIL = PipelineConfig.make(
    [("bilateral_blur", {"kernel_size": 5}), ("unsharp_mask", {"radius": 1.5})])


def _levels_close(a: np.ndarray, b: np.ndarray) -> None:
    """<= 1 uint8 level on < 0.1% of pixels (rounding ties only)."""
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("quantize", [False, True])
def test_k13_plain_matches_pallas_fused_tail(rng, quantize):
    """Plain K13 against _fused_kernel in interpret mode, [2, 128, 128],
    k5 sigma_c 0.1 sigma_s 1.5 r1.5: f32 within 1e-6, uint8 within one
    level on < 0.1% of pixels (tests/test_kernels.py's contract)."""
    import jax.numpy as jnp
    from mies_tpu.kernels.fused import bilateral_unsharp_tpu

    imgs = rng.random((2, 128, 128)).astype(np.float32)
    ref = np.asarray(bilateral_unsharp_tpu(
        jnp.asarray(imgs), 5, 0.1, 1.5, "reflect", 1.5, 1.0,
        quantize=quantize, interpret=True))
    out = KF.bilateral_unsharp_cuda(torch.from_numpy(imgs), 5, 0.1, 1.5,
                                    "reflect", 1.5, 1.0, quantize).numpy()
    assert out.dtype == (np.uint8 if quantize else np.float32)
    if quantize:
        _levels_close(out, ref)
    else:
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["reflect", "mirror", "nearest"])
def test_k13_plain_is_the_unfused_tail(rng, mode):
    """On the CPU the wrapper is the plain K3 -> K4 composition (any shape,
    smaller than the kernel's tile too)."""
    x = torch.from_numpy(rng.random((2, 37, 45)).astype(np.float32))
    want = KU.unsharp_quant_cuda(KB.bilateral_cuda(x, 7, 0.2, 2.0, mode), 1.0, 0.7)
    assert torch.equal(KF.bilateral_unsharp_cuda(x, 7, 0.2, 2.0, mode, 1.0, 0.7),
                       want)


def test_k13_limits_are_the_kernels():
    """k odd <= 9 with K3's borders; the Gaussian's radius within the taps
    and its tiles within a block's shared memory; any image shape."""
    assert KF.bilateral_unsharp_supported(5, 1.5)
    assert KF.bilateral_unsharp_supported(9, 8.0, "nearest")
    assert not KF.bilateral_unsharp_supported(11, 1.5)
    assert not KF.bilateral_unsharp_supported(4, 1.5)
    assert not KF.bilateral_unsharp_supported(5, 1.5, "wrap")
    assert not KF.bilateral_unsharp_supported(5, 0.0)
    assert not KF.bilateral_unsharp_supported(5, 20.0)  # rg 80 > 64 taps
    assert KF.smem_bytes(5, 6) == 4 * (25 + 13 + 80 * 80 + 76 * 76)
    assert KF.smem_bytes(9, 64) > KF.SMEM_MAX  # within the taps, not memory
    assert not KF.bilateral_unsharp_supported(9, 16.0)
    with pytest.raises(ValueError, match="K13 takes"):
        KF.bilateral_unsharp_cuda(torch.zeros((1, 8, 8)), 11)


def test_fuse_tail_env_gate(monkeypatch):
    """MIES_TPU_FUSE_TAIL gates the peephole: off by default, on only with
    '1' and a chain on the card, and only for a tail K13 takes."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    monkeypatch.delenv("MIES_TPU_FUSE_TAIL", raising=False)
    stages, fused = C._try_fuse_tail(TAIL, True, cuda)
    assert fused is None and len(stages) == 2
    monkeypatch.setenv("MIES_TPU_FUSE_TAIL", "0")
    assert C._try_fuse_tail(TAIL, True, cuda)[1] is None
    monkeypatch.setenv("MIES_TPU_FUSE_TAIL", "1")
    assert C._try_fuse_tail(TAIL, True, cpu)[1] is None
    stages, fused = C._try_fuse_tail(flagship_config(), False, cuda)
    assert [s.op for s in stages] == ["clahe"]
    assert fused.func is KF.bilateral_unsharp_cuda
    assert fused.keywords == {
        "kernel_size": 5, "sigma_color": 0.1, "sigma_space": 1.5,
        "bilateral_mode": "reflect", "radius": 1.5, "amount": 1.0,
        "quantize": False}
    for bad in ({"mode": "reflect"}, {"clip": False}):
        cfg = PipelineConfig.make([("bilateral_blur", {}),
                                   ("unsharp_mask", {"radius": 1.5, **bad})])
        assert C._try_fuse_tail(cfg, True, cuda)[1] is None
    wide = PipelineConfig.make([("bilateral_blur", {"kernel_size": 5}),
                                ("unsharp_mask", {"radius": 20.0})])
    assert C._try_fuse_tail(wide, True, cuda)[1] is None  # past K13's taps
    assert C._try_fuse_tail(PipelineConfig.make(
        [("unsharp_mask", {"radius": 1.5})]), True, cuda)[1] is None


def test_fuse_tail_switch_leaves_the_cpu_chain_alone(rng, monkeypatch):
    """On the CPU the chain stays unfused with the switch on: same output."""
    x = rng.random((2, 64, 64)).astype(np.float32)
    monkeypatch.delenv("MIES_TPU_FUSE_TAIL", raising=False)
    off = C.compile_pipeline(flagship_config(), batched=True, device="cpu")(x)
    monkeypatch.setenv("MIES_TPU_FUSE_TAIL", "1")
    on = C.compile_pipeline(flagship_config(), batched=True, device="cpu")(x)
    assert torch.equal(off, on)


# --- on the card ----------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 251, 333), (3, 20, 17), (1, 128, 64)])
@pytest.mark.parametrize("mode,k", [("reflect", 5), ("mirror", 3), ("nearest", 9)])
@pytest.mark.parametrize("quantize", [True, False])
def test_k13_on_card_equals_k3_k4(cuda_device, shape, mode, k, quantize):
    """K13 == K3 -> K4 bit for bit (images smaller than the tile too), and
    within K3's contract of the plain unfused tail."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.random(shape).astype(np.float32)).to(cuda_device)
    got = KF.bilateral_unsharp_cuda(x, k, 0.1, 1.5, mode, 1.5, 1.0, quantize)
    want = KU.unsharp_quant_cuda(KB.bilateral_cuda(x, k, 0.1, 1.5, mode), 1.5,
                                 1.0, quantize=quantize)
    assert torch.equal(got, want)
    plain = KF.bilateral_unsharp_plain(x, k, 0.1, 1.5, mode, 1.5, 1.0, quantize)
    if quantize:
        _levels_close(got.cpu().numpy(), plain.cpu().numpy())
    else:
        assert (got - plain).abs().max().item() <= 2e-6


@pytest.mark.cuda
def test_fused_tail_chain_on_card(cuda_device, monkeypatch):
    """With the switch on, the flagship chain launches K1 (to the LUTs),
    K2 and K13 once each and no K3 or K4, and its output equals the
    default chain's."""
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.random((4, 256, 256)).astype(np.float32)).to(cuda_device)
    monkeypatch.delenv("MIES_TPU_FUSE_TAIL", raising=False)
    off = C.compile_pipeline(flagship_config(), batched=True)(x)
    monkeypatch.setenv("MIES_TPU_FUSE_TAIL", "1")
    fn = C.compile_pipeline(flagship_config(), batched=True)
    _build.reset_launches()
    on = fn(x)
    torch.cuda.synchronize()
    launched = {k: v for k, v in _build.LAUNCHES.items() if v}
    assert launched == {"tile_luts": 1, "clahe_apply_lut": 1,
                        "bilateral_unsharp": 1}
    assert torch.equal(on, off)
