"""Device ms per batch of the hand kernels, matched by the patterns of
portbench/kernels/."""


def read(run):
    t = run.traced
    if not t or not any(t.kernel_of):
        return None
    us = sum(dur for (_, _, dur), k in zip(t.ops, t.kernel_of) if k)
    return us * 1e-3 / t.calls
