"""Command-line tools of the port (``python -m ssdnerf_torch.tools.<name>``)."""
