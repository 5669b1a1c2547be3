"""Model FLOPs of the untraced window's alignments (counted on the plain
reference at the cell's shapes, ``FlopCounterMode``) over the window's
seconds at the configuration's dtype peak."""
from h100bench.readers import mfu_pct


def read(trace, counters, config):
    return mfu_pct(counters, config)
