"""Share of the traced sub-window, in %, in which no kernel, copy or fill
runs on the device: one minus the union of the device intervals over the
window, from the first issue to the last completion seen."""


def read(run):
    t = run.traced
    if not t or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
