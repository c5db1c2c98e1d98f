"""The benchmark of ``ssdnerf_torch`` (``README.md``): ``run.py`` runs one
cell; everything a cell, a configuration, an entry kind or a per-layer
metric needs is found by file name."""
