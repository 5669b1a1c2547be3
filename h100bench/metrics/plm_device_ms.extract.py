"""Device milliseconds of the work issued under the program's
``omegafold.plm`` spans (OmegaPLM's 66 layers over the pseudo-MSA), per
recycling cycle (the program's ``omegafold.cycle`` spans)."""


def read(trace, counters, config):
    plm = trace.in_window("omegafold.plm")
    cycles = trace.in_window("omegafold.cycle")
    if not plm or not cycles:
        return None
    return 1e3 * trace.range_device_s(plm) / len(cycles)
