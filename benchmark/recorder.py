"""What the port recorded about itself, as the per-layer readers read it:
the spans and counters of its recorder (`ssvio_tpu_torch/utils/
profiling.py`, `TRACE`), on `time.perf_counter_ns`, the clock of
`Run.window`.

The window's records are those made between its start and its end; the
slice's, those made after the window's end (the traced slice follows the
window, and the engine times its frames on the device only while a
profiler runs). A checkout whose port has no recorder gives None, and so
do its readers.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def trace():
    """The port's recorder, or None."""
    try:
        from ssvio_tpu_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "TRACE", None)


def window(run) -> Tuple[int, int]:
    """The run's window in ns of the recorder's clock."""
    return int(run.window[0] * 1e9), int(run.window[1] * 1e9)


def slice_values(run, counter: str) -> Optional[List[float]]:
    """The values of `counter` recorded in the slice, or None without a
    recorder or a window."""
    tr = trace()
    if tr is None or run.seconds <= 0:
        return None
    return [c.value for c in tr.counts(counter, window(run)[1])]


def slice_by_frame(run, counter: str) -> dict:
    """{frame: value} of `counter` in the slice ({} without a recorder)."""
    tr = trace()
    if tr is None or run.seconds <= 0:
        return {}
    return {c.frame: c.value for c in tr.counts(counter, window(run)[1])}
