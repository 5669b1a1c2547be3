"""Device milliseconds of the work issued under the program's
``alphafold.evoformer`` spans (the 48 Evoformer blocks and the single
projection), per recycle (the program's ``alphafold.recycle`` spans)."""


def read(trace, counters, config):
    ranges = trace.in_window("alphafold.evoformer")
    recycles = trace.in_window("alphafold.recycle")
    if not ranges or not recycles:
        return None
    return 1e3 * trace.range_device_s(ranges) / len(recycles)
