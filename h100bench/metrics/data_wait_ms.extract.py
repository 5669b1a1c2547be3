"""Milliseconds a sequence in which the card runs nothing while the main
thread does the data side's work: the device's idle time inside the union
of the program's ``extract.pipeline`` (a sequence's pseudo-MSA cycles),
``omegafold.inputs`` (a cycle's copies to the card), ``omegafold.readback``
(the host's reads of the choice and the confidences) and ``extract.fetch``
(the reprs' copies to the host) spans, over the profiled sequences
(``bench.unit`` ranges). Nested or overlapping spans count once."""
from h100bench.trace import UNIT, clip, merged

SPANS = ("extract.pipeline", "omegafold.inputs", "omegafold.readback",
         "extract.fetch")


def read(trace, counters, config):
    data = merged(clip([(s, e) for name in SPANS
                        for s, e, tid in trace.in_window(name)
                        if tid == trace.main_thread], *trace.window))
    sequences = len(trace.in_window(UNIT))
    if not data or not sequences:
        return None
    busy = merged(trace.device_intervals())
    covered = sum(be - bs for s, e in data for bs, be in clip(busy, s, e))
    idle = sum(e - s for s, e in data) - covered
    return 1e-6 * idle / sequences
