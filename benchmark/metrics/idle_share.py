"""Share of the traced window in which no kernel, copy or set ran on the device."""


def read(run):
    if run.trace is None:
        return None
    return (1 - run.trace.busy_s / run.trace.window_s) * 100
