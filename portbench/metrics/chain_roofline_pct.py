"""The chain's least time over its device time per batch, in %.

The least time counts the chain's raw input once and its uint8 output
once, and the operations of ingest, every stage (at the reference stage
files' counts) and the quantize; the device time is the union of the
device intervals. Whatever a later change fuses or removes, the share
stays at or below 100%."""


def read(run):
    t = run.traced
    if not t or t.busy_s <= 0:
        return None
    least = sum(run.work(p).chain_least_s() for p in t.pool_index)
    return 100.0 * least / t.busy_s
