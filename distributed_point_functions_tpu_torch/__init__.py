"""Distributed Point Functions and dense two-server PIR on PyTorch and CUDA.

The PyTorch port of `distributed_point_functions_tpu`, held against it bit
for bit. It imports neither `jax` nor the JAX package: what it needs of
the JAX package's framework-free modules is copied here.

Every entry point takes `device=None`, which means the CUDA card; pass
`device="cpu"` to run the plain PyTorch versions of the kernels on the
host (the CPU tests do). See `pir.server.DenseDpfPirServer` for the main
path, `heavy_hitters` for the private heavy-hitters sweep, and `interop`
for carrying state across from the JAX package.
"""
