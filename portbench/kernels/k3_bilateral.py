"""K3, csrc/bilateral.cu bilateral_strip: the k x k bilateral filter."""

NAME = "K3"
PATTERN = r"\bbilateral_strip\b"
LAUNCHES = "bilateral"


def work(w):
    n = len(w.params("bilateral_blur"))
    if not n:
        return None
    return 8 * w.px * n, w.stage_ops("bilateral_blur")
