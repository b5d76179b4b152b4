"""Host ms from a step's call into the program until it returns, before the
read that waits for the card: the mean over the untraced window.  As it nears
the step's time, the host paces the cell."""


def read(run):
    return sum(run.window.dispatch_s) / run.window.steps * 1e3
