"""loopclosing.ms_per_frame.offline: host ms in the loop closer
(LoopClosing.process_keyframes_batch, the keyframes' ingest at a chunk's
collect, and LoopClosing.poll, the deferred verifications), summed over
the window and divided by its frames."""


def read(run):
    if run.settings.loop_closing_open is False or not run.frames:
        return None
    ms = (run.in_window("loopclosing.process_keyframes_batch")
          + run.in_window("loopclosing.poll"))
    return sum(ms) / run.frames if ms else None
