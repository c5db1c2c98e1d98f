"""Models of the port (torch counterparts of ``ssdnerf_tpu/models``)."""
