"""K4, csrc/unsharp.cu unsharp_strip: unsharp_mask with the chain's
uint8 quantize folded in when it is the last stage."""

NAME = "K4"
PATTERN = r"\bunsharp_strip\b"
LAUNCHES = "unsharp_quant"


def work(w):
    n = len(w.params("unsharp_mask"))
    if not n:
        return None
    if w.last_op() == "unsharp_mask":  # the tail writes uint8
        return 5 * w.px * n, w.stage_ops("unsharp_mask") + w.quantize_ops()
    return 8 * w.px * n, w.stage_ops("unsharp_mask")
