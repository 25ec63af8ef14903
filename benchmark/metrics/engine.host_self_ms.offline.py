"""engine.host_self_ms.offline: the host's own ms a frame, the mean over
the window's `engine.frame` spans (one per Engine._step) of the span less
its `engine.read` child (the host read a tracked frame waits on the device
in, and an init frame's gate)."""

from benchmark import recorder


def read(run):
    tr = recorder.trace()
    if tr is None or run.seconds <= 0:
        return None
    frames = tr.spans("engine.frame", *recorder.window(run))
    own = tr.self_ns(frames, ("engine.read",))
    return 1e-6 * sum(own) / len(own) if own else None
