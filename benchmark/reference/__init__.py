"""The benchmark's plain reference: a frozen copy (``ssd/``) of the port's
model code that the cells run, with every kernel wrapper replaced by its
plain PyTorch version,
and the controls, the same computation in the precision below the one a
configuration states (:mod:`.controls`).  It imports nothing of the port
or of JAX, and takes nothing the port has made: the benchmark hands both
sides the same config, weights and inputs."""
