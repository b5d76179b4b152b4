"""Game turns completed in the window over the window's seconds: G x 10 a step
or match, every step sent counted, the window ending at the last one's read."""


def read(run):
    return run.window.steps * run.cell.env_steps / run.window.seconds
