"""Share of the roofline of the GeoFormer's two gated attentions
(``geom_attention`` and ``node_attention``) over the profiled
sequence(s)."""
from h100bench.readers import op_roofline


def read(trace, counters, config):
    return op_roofline(trace, counters, config, "bench.op.geom")
