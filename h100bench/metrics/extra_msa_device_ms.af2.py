"""Device milliseconds of the work issued under the program's
``alphafold.extra_msa_stack`` spans (the 4 extra-MSA blocks), per recycle
(the program's ``alphafold.recycle`` spans)."""


def read(trace, counters, config):
    ranges = trace.in_window("alphafold.extra_msa_stack")
    recycles = trace.in_window("alphafold.recycle")
    if not ranges or not recycles:
        return None
    return 1e3 * trace.range_device_s(ranges) / len(recycles)
