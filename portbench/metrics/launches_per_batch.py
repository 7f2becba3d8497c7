"""Device operations (kernels, copies, fills) per batch in the trace."""


def read(run):
    t = run.traced
    return len(t.ops) / t.calls if t else None
