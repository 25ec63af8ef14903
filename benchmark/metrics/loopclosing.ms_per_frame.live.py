"""loopclosing.ms_per_frame.live: host ms in LoopClosing.process_keyframe,
the loop closing that run_step makes inline after a keyframe, summed over
the window and divided by its frames."""


def read(run):
    if run.settings.loop_closing_open is False or not run.frames:
        return None
    ms = run.in_window("loopclosing.process_keyframe")
    return sum(ms) / run.frames if ms else None
