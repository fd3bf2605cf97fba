"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version and a launch count. Sources live in ``csrc/`` and are
built at first use by ``kernels._build``."""
