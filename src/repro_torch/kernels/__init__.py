"""Hand-written Hopper kernels for the port's hot spots.

Each kernel package mirrors ``src/repro/kernels/<name>/``: ``ops.py`` holds
the wrapper the models call, ``ref.py`` the plain PyTorch version of the
same function.  The kernels themselves are CUDA C++ in ``csrc/``, built by
``_build.py`` at first use.  A wrapper takes its plain version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
Each wrapper counts its kernel launches in its ``launches`` attribute.
"""
