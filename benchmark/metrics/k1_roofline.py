"""K1's share of its roofline: the least time of one turn's resolution at the
cell's G (``flops.bound_s`` of K1's bytes and operations; the bytes bound it)
over K1's mean device time a launch in the trace."""

from ..flops import bound_s, k1_bytes, k1_ops


def read(run):
    if run.trace is None:
        return None
    mean_s = run.trace.kernel_mean_s("resolve_turn_kernel")
    if not mean_s:
        return None
    r, g = run.cell.rules, run.cell.G
    return bound_s(k1_bytes(g, r.num_players, r.num_rows, r.threshold), k1_ops(g, r.num_players)) / mean_s * 100
