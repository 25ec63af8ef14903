"""engine.outside_graphs_ms.offline: the device's ms a frame outside its
tracking and keyframe calls, the mean over the traced slice's frames of
`engine.period_ms` (from the frame's start event to the next frame's, or
to the chunk's end after its readback is packed) less its
`engine.track_ms` and `engine.keyframe_ms`: the device idle while the host
runs Python, or running the eager ops between the graphs."""

from benchmark import recorder


def read(run):
    period = recorder.slice_by_frame(run, "engine.period_ms")
    if not period:
        return None
    track = recorder.slice_by_frame(run, "engine.track_ms")
    kf = recorder.slice_by_frame(run, "engine.keyframe_ms")
    out = [p - track.get(f, 0.0) - kf.get(f, 0.0) for f, p in period.items()]
    return sum(out) / len(out)
