"""Command-line tools of the port: ``python -m
pathtrace_tpu_torch.tools.watch`` (the live terminal preview)."""
