"""Execution engines: the same limb-level kernels instantiated over numpy
(host golden path) or jax.numpy (device path)."""
