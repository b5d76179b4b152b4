"""Game turns completed in the window over the window's seconds: G x 10 a step or match."""


def read(run):
    return run.window.steps * run.cell.env_steps / run.window.seconds
