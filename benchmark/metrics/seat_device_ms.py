"""Device ms a match of the kernels the host launched inside the arena's
``arena.seat.<kind>`` spans: each seat's whole rule, its net forward included."""

from ..program_spans import device_ms


def read(run):
    return device_ms(run, "arena.seat.")
