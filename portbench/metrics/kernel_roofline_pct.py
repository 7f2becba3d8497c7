"""The hand kernels' least time over their summed device time, in %.

A kernel's least time for a batch is the larger of its bytes over the
bandwidth and its operations over the float32 rate, counted by its file
under portbench/kernels/ from the stage's work (input read once, output
written once, the stage's own operations). Summed over every traced call
and every kernel seen in the trace."""

from portbench import roofline


def read(run):
    t = run.traced
    if not t:
        return None
    seen = {k.NAME: k for k in t.kernel_of if k}
    if not seen:
        return None
    us = sum(dur for (_, _, dur), k in zip(t.ops, t.kernel_of) if k)
    least = 0.0
    for p in t.pool_index:
        w = run.work(p)
        for k in seen.values():
            got = k.work(w)
            if got is None:
                raise ValueError(f"kernel {k.NAME} ran, but counts no work "
                                 f"for this chain")
            least += roofline.least_s(*got)
    return 100.0 * least / (us * 1e-6)
