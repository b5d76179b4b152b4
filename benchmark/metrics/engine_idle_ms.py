"""The device's idle ms a step or match while the innermost open host span was
one of the program's ``engine.*`` spans: how long the engine's own dispatch
keeps the card waiting."""

from ..program_spans import idle_ms


def read(run):
    return idle_ms(run, "engine.")
