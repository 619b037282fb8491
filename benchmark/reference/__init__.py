"""The plain reference the benchmark holds the port's outputs to.

Plain PyTorch, written from the configuration alone: grids, next states,
interpolation corners, costs, value iteration, the closed-loop plant. It
imports nothing of ``ocdp_tpu_torch`` (nor of the JAX package) and takes
nothing the port made; the port's outputs reach it only to be judged.
"""
