"""engine.tracked_frame_ms.live: the median host ms of run_step on tracked
frames that made no keyframe (the tracking graph's replay; the call ends
synchronised, since it returns the pose as numpy)."""

import statistics


def read(run):
    ms = [r["step_ms"] for r in run.live
          if r["tracked"] and not r["keyframe"]]
    return float(statistics.median(ms)) if ms else None
