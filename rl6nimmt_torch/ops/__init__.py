"""Hand-written CUDA kernels (K1-K7), their plain PyTorch twins, and Philox.

JAX's package exports its K1 factories ``make_turn_resolver`` and
``make_turn_resolver_t``; the port's K1 entries are ``resolve_turn`` (row-major)
and ``resolve_turn_t`` (games-last), PARITY_TORCH.md section 11.  Nothing is
built at import: a kernel compiles at its first launch.
"""

from .step_kernel import resolve_turn, resolve_turn_t

__all__ = ["resolve_turn", "resolve_turn_t"]
