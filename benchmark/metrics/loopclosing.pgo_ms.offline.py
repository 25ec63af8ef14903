"""loopclosing.pgo_ms.offline: the mean host ms of a pose-graph
optimisation over the window: the port's `loopclosing.pgo` spans (a child
of `loopclosing.correct`: the graph built from the host keyframe records,
the LM solve and its read back, the records and the database's landmark
snapshots re-anchored). None where the window ran no PGO or the port
records no such span."""

from benchmark import recorder


def read(run):
    tr = recorder.trace()
    if tr is None or run.seconds <= 0:
        return None
    ms = [1e-6 * (s.t1 - s.t0)
          for s in tr.spans("loopclosing.pgo", *recorder.window(run))]
    return sum(ms) / len(ms) if ms else None
