"""Command-line entry points of the port (``python -m litepose_tpu_torch.tools.<name>``)."""
