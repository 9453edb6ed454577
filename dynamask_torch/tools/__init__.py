"""Command-line entry points of the port (``python -m
dynamask_torch.tools.<name>``)."""
