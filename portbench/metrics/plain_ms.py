"""Device ms per batch of every device operation that is no hand
kernel: plain torch (ops/, the chain's ingest and quantize), copies and
fills."""


def read(run):
    t = run.traced
    if not t:
        return None
    us = sum(dur for (_, _, dur), k in zip(t.ops, t.kernel_of) if k is None)
    return us * 1e-3 / t.calls
