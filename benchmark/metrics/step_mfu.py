"""The whole step's share of the card's float32 peak: the nets' model FLOPs a
step (from shapes, ``flops.py``) over the mean step time of the untraced window."""

from ..flops import F32_OPS_PER_S


def read(run):
    step_s = run.window.seconds / run.window.steps
    return run.cell.model_flops / step_s / F32_OPS_PER_S * 100
