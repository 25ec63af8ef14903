"""device.idle_share.offline: the share of the traced slice, in %, in
which no kernel, memcpy or memset ran on the device (1 - the union of
their intervals over the slice's length)."""


def read(run):
    sl = run.slice
    if sl is None or sl.window_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
