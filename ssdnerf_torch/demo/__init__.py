"""Demos of the port (``python -m ssdnerf_torch.demo.<name>``)."""
