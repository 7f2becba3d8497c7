"""K2, csrc/clahe.cu apply_lut_kernel: the opencv CLAHE's bilinear blend
of four tile LUTs and its uint8 epilogue."""

NAME = "K2"
PATTERN = r"\bapply_lut_kernel\b"
LAUNCHES = "clahe_apply_lut"
NBINS = 256


def work(w):
    tiles = sum(int(p["grid_size"][0]) * int(p["grid_size"][1])
                for p in w.params("clahe"))
    if not tiles:
        return None
    n = len(w.params("clahe"))
    luts = 4 * NBINS * tiles * w.shape[0]
    return 8 * w.px * n + luts, 29 * w.px * n
