"""K12, csrc/tv.cu tv_chunk and tv_energy: TV-Chambolle, three launches a
chunk of 4 steps. The stage's work is 22 operations a pixel and step for
the steps each slice needs (the reference's), its input read once and its
output written once, whatever the launches reread."""

NAME = "K12"
PATTERN = r"\btv_(chunk|energy)\b"
LAUNCHES = "tv"


def work(w):
    n = len(w.params("denoise_tv"))
    if not n:
        return None
    return 8 * w.px * n, w.stage_ops("denoise_tv")
