"""loopclosing.correct_ms.offline: the mean host ms of an accepted loop
correction over the window: the port's `loopclosing.correct` spans (a
child of `loopclosing.verify`: the active map re-anchored, the landmarks
fused, the map installed into the System, and the PGO). None where the
window made no correction or the port records no such span."""

from benchmark import recorder


def read(run):
    tr = recorder.trace()
    if tr is None or run.seconds <= 0:
        return None
    ms = [1e-6 * (s.t1 - s.t0)
          for s in tr.spans("loopclosing.correct", *recorder.window(run))]
    return sum(ms) / len(ms) if ms else None
