"""The work counts behind the roofline shares, against hand values."""

import pytest
import torch

from portbench import harness, roofline
from portbench.reference import chain as ref_chain
from portbench.tests.conftest import CELLS

PX = 4 * 16 * 16


def _work(stages, shape=(4, 16, 16), info=None, io=torch.uint8):
    return harness.Work(stages, shape, io, info or {}, ref_chain.OPS_DIR)


def test_bilateral_is_136_a_pixel_at_k5():
    mod = ref_chain.load_op("bilateral_blur")
    assert mod.operations((4, 16, 16), {}, kernel_size=5) == 136 * PX


def test_unsharp_is_60_a_pixel_at_r15_with_the_quantize():
    w = _work([("unsharp_mask", {"radius": 1.5, "amount": 1.0})])
    k4 = harness._module(harness.ROOT / "portbench/kernels/"
                         "k4_unsharp_quant.py")
    nbytes, ops = k4.work(w)
    assert ops == 60 * PX          # 13 taps: 4 a tap + 8
    assert nbytes == 5 * PX        # float32 in, uint8 out


def test_nl_means_is_84_pairs_of_22_at_s5_d6():
    mod = ref_chain.load_op("denoise_nl_means")
    assert len(mod.half_shift_table(6)) == 84
    assert mod.operations((4, 16, 16), {}, patch_size=5,
                          patch_distance=6) == 84 * 22 * PX


def test_tv_counts_the_steps_each_slice_needs():
    mod = ref_chain.load_op("denoise_tv")
    steps = torch.tensor([3, 5, 60, 1])
    assert mod.operations((4, 16, 16), {"denoise_tv.steps": steps},
                          max_num_iter=60) == 22 * 69 * 256


def test_clahe_kernels_split_the_stage():
    clahe = {"clip_limit": 2.0, "grid_size": [8, 8], "convention": "opencv"}
    w = _work([("clahe", clahe)])
    ks = {k.NAME: k for k in harness.kernel_specs(harness.load_cell(CELLS[0]))}
    assert ks["K1L"].work(w)[1] + ks["K2"].work(w)[1] == w.stage_ops("clahe")
    assert ks["K3"].work(w) is None and ks["K11"].work(w) is None


def test_least_time_is_the_larger_bound():
    assert roofline.least_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert roofline.least_s(1.0, 67e12) == pytest.approx(1.0)


def test_the_chain_counts_its_input_once_and_its_uint8_output_once():
    cell = harness.load_cell(CELLS[0])
    w = harness.Work(cell.stages, (128, 512, 512), torch.uint8, {},
                     ref_chain.OPS_DIR)
    px = 128 * 512 * 512
    ops = (1 + 34 + 136 + 57 + 3) * px + 20 * 256 * 64 * 128
    assert w.chain_least_s() == pytest.approx(
        max(2 * px / 3.35e12, ops / 67e12))


def test_median_is_19_comparisons_a_pixel_at_k3():
    mod = ref_chain.load_op("median_blur")
    assert mod.operations((4, 16, 16), {}, kernel_size=3) == 19 * PX
