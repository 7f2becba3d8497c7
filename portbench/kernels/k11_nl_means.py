"""K11, csrc/nlmeans.cu nlm_kernel: non-local means."""

NAME = "K11"
PATTERN = r"\bnlm_kernel\b"
LAUNCHES = "nl_means"


def work(w):
    n = len(w.params("denoise_nl_means"))
    if not n:
        return None
    return 8 * w.px * n, w.stage_ops("denoise_nl_means")
