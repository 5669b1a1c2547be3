"""Device milliseconds of the work issued under the program's
``omegafold.geoformer`` ranges, per recycling cycle."""


def read(trace, counters, config):
    ranges = trace.in_window("omegafold.geoformer")
    if not ranges:
        return None
    return 1e3 * trace.range_device_s(ranges) / len(ranges)
