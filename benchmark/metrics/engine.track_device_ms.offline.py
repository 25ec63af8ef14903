"""engine.track_device_ms.offline: the median device ms of the tracking
call over the traced slice's tracked frames (the tracking graph's copies
in, its replay and its clones out): CUDA events around the port's
`engine.track` span, read at the chunk's collect as `engine.track_ms`."""

import statistics

from benchmark import recorder


def read(run):
    ms = recorder.slice_values(run, "engine.track_ms")
    return float(statistics.median(ms)) if ms else None
