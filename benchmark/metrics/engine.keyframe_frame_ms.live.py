"""engine.keyframe_frame_ms.live: the median host ms of run_step on steady
keyframes (tracked frames that made a keyframe: the tracking graph, the
keyframe graph with the local BA), less the loop closing the call made
inline (LoopClosing.process_keyframe inside the call)."""

import statistics


def read(run):
    spans = run.spans.spans.get("loopclosing.process_keyframe", [])
    ms = []
    for r in run.live:
        if r["tracked"] and r["keyframe"]:
            loop = sum(b - a for a, b in spans
                       if r["start"] <= a and b <= r["end"])
            ms.append(r["step_ms"] - 1e3 * loop)
    return float(statistics.median(ms)) if ms else None
