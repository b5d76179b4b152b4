"""Device ms a step or match of the kernels the host launched inside the
program's ``engine.*`` spans (``engine/env.py``: the deal, each observation,
each turn), matched by the launches' correlation ids."""

from ..program_spans import device_ms


def read(run):
    return device_ms(run, "engine.")
