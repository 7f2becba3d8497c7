"""Host ms a chain call takes to return (it returns before the card
finishes): the mean over the calls of the measured window, outside the
profiled sub-window."""


def read(run):
    d = run.window.dispatch_s
    return 1e3 * sum(d) / len(d) if d else None
