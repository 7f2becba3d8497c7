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
    """k odd <= 9 with K3's borders; the Gaussian's radius within the taps,
    its strip keeping an output column, and its rings within a block's
    shared memory; any image shape."""
    assert KF.bilateral_unsharp_supported(5, 1.5)
    assert KF.bilateral_unsharp_supported(9, 8.0, "nearest")
    assert not KF.bilateral_unsharp_supported(11, 1.5)
    assert not KF.bilateral_unsharp_supported(4, 1.5)
    assert not KF.bilateral_unsharp_supported(5, 1.5, "wrap")
    assert not KF.bilateral_unsharp_supported(5, 0.0)
    assert not KF.bilateral_unsharp_supported(5, 20.0)  # rg 80 > 63 taps
    # rg 6 (the flagship's): registers, a 256-column strip and its halo of 6;
    # K3's rings of 3 input rows of 276 columns and 3 x 12 weight rows of
    # 272, the staged bilateral row and vertical sums
    assert KF.strip_columns(6) == 256
    assert KF.smem_bytes(5, 6) == 4 * (3 * (276 + 12 * 272) + 2 * 268)
    assert KF.smem_bytes(9, 6) <= KF.SMEM_MAX
    # rg 7: a 128-column bilateral strip for 114 outputs, the taps and a
    # ring of 15 bilateral rows in shared memory
    assert KF.strip_columns(7) == 114
    assert KF.smem_bytes(5, 7) == 4 * (3 * (136 + 12 * 132) + 2 * 128
                                       + 15 * 129)
    assert KF.smem_bytes(9, 63) <= KF.SMEM_MAX  # every radius fits at k 9
    assert KF.strip_columns(64) == 0  # within the taps, not the strip
    assert not KF.bilateral_unsharp_supported(9, 16.0)  # rg 64
    assert KF.bilateral_unsharp_supported(9, 15.75)  # rg 63
    with pytest.raises(ValueError, match="K13 takes"):
        KF.bilateral_unsharp_cuda(torch.zeros((1, 8, 8)), 11)


def _old_k13_supported(k: int, radius: float, mode: str) -> bool:
    """K13's limits before its strip-walk design, frozen: 64 x 64 output
    tiles whose input (halo k // 2 + rg) and bilateral (halo rg) tiles,
    the spatial weights and the taps fit 232,448 bytes, rg <= 64."""
    if k % 2 != 1 or not 1 <= k <= 9:
        return False
    if mode not in ("reflect", "mirror", "nearest", "edge") or radius <= 0:
        return False
    rg = int(4.0 * radius + 0.5)
    xw, bw = 64 + 2 * (k // 2 + rg), 64 + 2 * rg
    return (1 <= rg <= 64
            and 4 * (k * k + 2 * rg + 1 + xw * xw + bw * bw) <= 232448)


@pytest.mark.parametrize("k", [1, 3, 5, 7, 9])
def test_k13_takes_every_tail_it_took(k):
    """The strip walk accepts every (k, radius, border) that the 64 x 64
    tile design accepted (up to rg 50-53 by k), and more."""
    took = 0
    for rg in range(1, 65):
        for mode in ("reflect", "mirror", "nearest", "edge"):
            if _old_k13_supported(k, rg / 4.0, mode):
                took += 1
                assert KF.bilateral_unsharp_supported(k, rg / 4.0, mode), \
                    (k, rg, mode)
    assert took >= 4 * 50
    assert KF.bilateral_unsharp_supported(k, 63 / 4.0)


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


# K13 walks strips (256 output columns at rg 6 and 4, 128 - 2 rg at other
# radii) down runs of 128 rows (csrc/fused.cu kStripW, kWideW, kRunRows):
# shapes below, across and beyond one strip and one run on each axis
K13_SHAPES = [(1, 1), (5, 31), (31, 5), (33, 127), (127, 33), (129, 140),
              (140, 129), (257, 300), (513, 513)]


@pytest.mark.cuda
@pytest.mark.parametrize("rg", [1, 4, 6, 7, 16])
@pytest.mark.parametrize("mode", ["reflect", "mirror", "nearest"])
@pytest.mark.parametrize("k", [1, 3, 5, 7, 9])
def test_k13_on_card_is_k3_then_k4(cuda_device, k, mode, rg):
    """Bit-equal to K3 -> K4 at every radius K4 takes (registers at rg 6
    and 4, the shared-memory ring at 1, 7 and 16), both quantize modes."""
    rng = np.random.default_rng(100 + rg)
    for h, w in K13_SHAPES:
        x = torch.from_numpy(rng.random((2, h, w)).astype(np.float32)).to(
            cuda_device)
        b = KB.bilateral_cuda(x, k, 0.1, 1.5, mode)
        for quantize in (True, False):
            _build.reset_launches()
            got = KF.bilateral_unsharp_cuda(x, k, 0.1, 1.5, mode, rg / 4.0,
                                            1.0, quantize)
            assert _build.LAUNCHES["bilateral_unsharp"] == 1
            want = KU.unsharp_quant_cuda(b, rg / 4.0, 1.0, quantize=quantize)
            assert torch.equal(got, want), (h, w, quantize)


@pytest.mark.cuda
@pytest.mark.parametrize("rg", [17, 33, 50, 51, 63])
@pytest.mark.parametrize("mode", ["reflect", "nearest"])
@pytest.mark.parametrize("k", [3, 9])
def test_k13_on_card_past_k4s_radii_matches_plain(cuda_device, k, mode, rg):
    """Where K4 has no radius (rg > 16, up to 63, where a strip keeps 2
    output columns): within K3's contract of the plain tail, f32 within 2e-6
    and uint8 within one level on rounding ties."""
    rng = np.random.default_rng(200 + rg)
    for shape in [(2, 140, 150), (1, 1, 1), (1, 37, 300)]:
        x = torch.from_numpy(rng.random(shape).astype(np.float32)).to(
            cuda_device)
        for quantize in (False, True):
            got = KF.bilateral_unsharp_cuda(x, k, 0.1, 1.5, mode,
                                            rg / 4.0, 1.0, quantize)
            plain = KF.bilateral_unsharp_plain(x, k, 0.1, 1.5, mode,
                                               rg / 4.0, 1.0, quantize)
            if not quantize:
                assert (got - plain).abs().max().item() <= 2e-6, shape
            elif shape[1] > 1:
                _levels_close(got.cpu().numpy(), plain.cpu().numpy())
            else:
                assert (got.int() - plain.int()).abs().max().item() <= 1
