"""95th percentile, over every batch of the window, of the host's time
from issuing the batch to seeing its completion event (linear between
order statistics)."""


def read(run):
    lat = sorted(run.window.latency_s)
    if not lat:
        return None
    pos = 0.95 * (len(lat) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(lat) - 1)
    return 1e3 * (lat[lo] + (lat[hi] - lat[lo]) * (pos - lo))
