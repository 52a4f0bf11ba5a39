"""presight-tpu's serving path in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a).

The JAX package ``presight_tpu`` is the reference; this package imports
torch and never jax (its only import from ``presight_tpu`` is the jax-free
``presight_tpu.native``). Modules mirror the JAX package's layout:

configs   mirrors of the config dataclasses; named tile configs
bridge    JAX parameter trees <-> the port's tensors (same layouts)
kernels   build, load and launch counts of the CUDA kernels in csrc/
ops       hash encoding (K1), grouped MLP (K2), volume rendering (K3),
          samplers, rays, math
fields    expert routing, main field, proposal field and cached grid (K4),
          sky field
models    NerfactoNuscMS: eval forward, depth-only forward, point queries
engine    ImageRenderer (chunked whole-image rendering)
prior     prior extraction to the city-prior pickle

Each kernel wrapper launches its CUDA kernel on CUDA tensors and runs its
plain PyTorch version on CPU tensors.
"""
