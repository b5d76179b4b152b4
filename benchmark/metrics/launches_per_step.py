"""Kernel events in the traced window over the steps in it."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.launches / run.trace.steps
