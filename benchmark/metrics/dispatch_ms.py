"""Host ms a step that the call into the program spends outside the CUDA
runtime's own calls, read from the traced window: the host's work of sending a
step.  A launch that waits for room in the card's queue is left out, so this
stays the host's cost while a step is in flight; as it nears the step's time
on the card, the host paces the cell."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.step_host_s / run.trace.steps * 1e3
