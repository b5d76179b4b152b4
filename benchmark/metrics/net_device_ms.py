"""Device ms a step or match of the kernels the host launched inside the
program's ``nets.*`` spans (``nets.policy``: the action-in-input forward;
``nets.q``: the Q forward).  In training this is the forward only: the
backward's kernels are launched under ``reinforce.backward``."""

from ..program_spans import device_ms


def read(run):
    return device_ms(run, "nets.")
