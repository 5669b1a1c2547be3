"""Share of an untraced alignment's wall time in which no kernel, copy or
set runs on the card: the traced alignments' device seconds (the union of
their intervals over every stream) against the untraced window's seconds
an alignment."""
from h100bench.readers import idle_pct


def read(trace, counters, config):
    return idle_pct(trace, counters)
