"""Command-line entry points of the port (``python -m rl6nimmt_torch.cli.run``)."""
