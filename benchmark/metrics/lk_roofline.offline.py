"""lk_roofline.offline: the LK level kernels' share of their roofline in
the traced slice, in %: the least time of the pyramid levels the slice's
frames ran (`benchmark/work.py`: each level's four float32 planes, or the
points' windows in them where those are fewer, read once, at the H100's
published 3.35 TB/s) over the device time of the kernels that ran them
(`level_kernel`, `lk_patch_kernel`, `windows_kernel` by name)."""

from benchmark import work

NAMES = ("level_kernel", "lk_patch_kernel", "windows_kernel")


def _lk(name):
    return any(n in name for n in NAMES)


def read(run):
    sl = run.slice
    if sl is None or not run.slice_frames:
        return None
    device_s = sl.seconds(_lk)
    if device_s <= 0:
        return None
    h, w = run.canvas
    least = work.lk_least_seconds(run.settings, h, w, run.slice_frames)
    return 100.0 * least / device_s
