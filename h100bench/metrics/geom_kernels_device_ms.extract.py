"""Device milliseconds of the work issued under the program's
``ops.geom_attention`` and ``ops.node_attention`` spans (the GeoFormer's
two gated-attention wrappers, kernels and operand copies), per recycling
cycle (the program's ``omegafold.cycle`` spans)."""


def read(trace, counters, config):
    ops = (trace.in_window("ops.geom_attention")
           + trace.in_window("ops.node_attention"))
    cycles = trace.in_window("omegafold.cycle")
    if not ops or not cycles:
        return None
    return 1e3 * trace.range_device_s(ops) / len(cycles)
