"""ba.lm_steps_used.offline: the share, in %, of the LM steps the local
BAs of the traced slice ran that their data needed: 100 x the sum of
`ba.lm_steps_needed` (the steps the while_loops would take,
Engine.ba_trips) over the sum of `ba.lm_steps_run` (the fixed trip's
rounds x steps)."""

from benchmark import recorder


def read(run):
    ran = recorder.slice_values(run, "ba.lm_steps_run")
    if not ran or sum(ran) <= 0:
        return None
    return 100.0 * sum(recorder.slice_values(run, "ba.lm_steps_needed")) \
        / sum(ran)
