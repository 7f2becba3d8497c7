"""K1 to the LUTs, csrc/clahe.cu tile_luts_kernel: the opencv CLAHE's
tile histograms, clip, redistribution, cdf and LUTs."""

NAME = "K1L"
PATTERN = r"\btile_luts_kernel\b"
LAUNCHES = "tile_luts"
NBINS = 256


def work(w):
    tiles = sum(int(p["grid_size"][0]) * int(p["grid_size"][1])
                for p in w.params("clahe"))
    if not tiles:
        return None
    b = w.shape[0]
    n = len(w.params("clahe"))
    luts = 4 * NBINS * tiles * b
    # 5 a pixel (scale, round, two clamps, count), 20 a bin of a LUT
    return 4 * w.px * n + luts, 5 * w.px * n + 20 * NBINS * tiles * b
