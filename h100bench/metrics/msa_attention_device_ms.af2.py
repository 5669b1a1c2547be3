"""Device milliseconds of the work issued under the program's
``alphafold.msa_row_attention`` spans (both stacks: the Evoformer's on
``node_attention``, the extra stack's in plain torch) and
``alphafold.msa_column_attention`` spans (the Evoformer's), per recycle
(the program's ``alphafold.recycle`` spans)."""


def read(trace, counters, config):
    ranges = (trace.in_window("alphafold.msa_row_attention")
              + trace.in_window("alphafold.msa_column_attention"))
    recycles = trace.in_window("alphafold.recycle")
    if not ranges or not recycles:
        return None
    return 1e3 * trace.range_device_s(ranges) / len(recycles)
