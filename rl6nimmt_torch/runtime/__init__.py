"""Vectorized self-play runtime (port of ``rl6nimmt_tpu.runtime.vector``)."""
