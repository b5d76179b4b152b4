"""Ports of the JAX package's experiment scripts (``experiments/``): benchmarks, the
act-rollout ablation (K6) and the op probes (K7), training scripts, and the strength
evaluations, A/B tests and device-block profilers.  Run each with
``python -m rl6nimmt_torch.experiments.<name>``; nothing runs at import."""
