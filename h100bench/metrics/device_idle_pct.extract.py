"""Share of an untraced sequence's wall time in which no kernel, copy or
set runs on the card: the traced sequences' device seconds (the union of
their intervals over every stream) against the untraced window's seconds
a sequence."""
from h100bench.readers import idle_pct


def read(trace, counters, config):
    return idle_pct(trace, counters)
