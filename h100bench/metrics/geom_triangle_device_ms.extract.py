"""Device milliseconds of the work issued under the program's
``ops.geom_triangle`` spans (GeometricAttention's triangle-multiplicative
branch: its three kernels on the card, or the einsums of its plain
version), per recycling cycle (the program's ``omegafold.cycle`` spans)."""


def read(trace, counters, config):
    tri = trace.in_window("ops.geom_triangle")
    cycles = trace.in_window("omegafold.cycle")
    if not tri or not cycles:
        return None
    return 1e3 * trace.range_device_s(tri) / len(cycles)
