"""Ports of the JAX package's kernel experiments (``experiments/``): the act-rollout
ablation (K6) and the act kernel's building-block probes (K7).  Run each with
``python -m rl6nimmt_torch.experiments.<name>``; nothing runs at import."""
