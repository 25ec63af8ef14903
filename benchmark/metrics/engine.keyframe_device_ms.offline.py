"""engine.keyframe_device_ms.offline: the median device ms of the keyframe
call over the traced slice's steady keyframes (the keyframe graph's copies
in, its replay with the local BA and its clones out): `engine.keyframe_ms`
of the frames whose `engine.frame` span took the branch
"track+keyframe"."""

import statistics

from benchmark import recorder


def read(run):
    tr = recorder.trace()
    ms = recorder.slice_by_frame(run, "engine.keyframe_ms")
    if tr is None or not ms:
        return None
    t1 = recorder.window(run)[1]
    steady = {s.frame for s in tr.spans("engine.frame", t1)
              if s.tag == "track+keyframe"}
    ms = [v for f, v in ms.items() if f in steady]
    return float(statistics.median(ms)) if ms else None
