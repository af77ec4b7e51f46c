"""Hand-written Hopper kernels of the port, each beside its plain version.

Sources are in ``repro_torch/csrc``; ``_build`` compiles them with ``nvcc``
at the first launch.  Importing these modules builds nothing.
"""
