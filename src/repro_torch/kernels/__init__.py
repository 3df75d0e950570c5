"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each package has ``ref.py`` (the plain PyTorch version) and ``ops.py`` (the
wrapper: checks its arguments, runs the plain version for tensors on the CPU,
and launches the CUDA kernel from ``repro_torch/csrc`` for tensors on a GPU,
counting each launch).  ``_build`` compiles and loads the kernels.
"""
