"""loopclosing.verify_ms.offline: the mean host ms of a loop candidate's
verification over the window: the port's `loopclosing.verify` spans (one
per LoopClosing._complete_loop call: the match and PnP, their host read,
the gates, and a correction where one is accepted)."""

from benchmark import recorder


def read(run):
    tr = recorder.trace()
    if tr is None or run.seconds <= 0:
        return None
    ms = [1e-6 * (s.t1 - s.t0)
          for s in tr.spans("loopclosing.verify", *recorder.window(run))]
    return sum(ms) / len(ms) if ms else None
