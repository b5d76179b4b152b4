"""The 95th percentile of the times of all steps or matches in the window, on
the card's clock: each from the end of the step before on the card (the
window's start, for the first) to its own end, read from the events the
harness records after each step.  Without a card (the CPU tests), the same
on the host's clock, from read to read."""

import statistics


def read(run):
    ms = [s * 1e3 for s in (run.window.card_step_s or run.window.step_s)]
    return statistics.quantiles(ms, n=20)[18] if len(ms) >= 2 else ms[0]
