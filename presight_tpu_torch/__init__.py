"""presight-tpu's city-tile NeRF in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper (sm_90a): training, serving and prior extraction, for the
reference architecture and the -tpu profile.

The JAX package ``presight_tpu`` is the reference; this package imports
torch and never jax, and nothing of ``presight_tpu``. Modules mirror the
JAX package's layout:

configs   mirrors of the config dataclasses, the 73 named method configs
          (method_configs) and config.yml / CLI overrides (config_io)
bridge    JAX parameter trees <-> the port's tensors (same layouts)
kernels   build, load and launch counts of the CUDA kernels in csrc/
native    host libraries built by g++: the voxel accumulator and the JPEG
          codec (native/jpeg.py)
ops       hash encoding (K1, K1b, K5), grouped MLP (K2, K2b), volume
          rendering (K3, K3b), samplers, losses, rays, math
fields    expert routing, main field, proposal fields and cached grid (K4),
          sky field
models    NerfactoNuscMS: train and eval forward, losses, depth-only
          forward, point and field queries
data      cameras, the dataparser (with its k-means), image loading, the
          chunked dataset and data manager, device stores, the synthetic
          fixture
engine    Trainer (from disk or in memory) and train step, checkpoints,
          ImageRenderer and image metrics, reference-checkpoint import
prior     prior extraction to the city-prior pickle
utils     PSNR / SSIM, the event writer, spans and counters (profiler)
scripts   the train CLI

Each kernel wrapper launches its CUDA kernel on CUDA tensors and runs its
plain PyTorch version on CPU tensors.
"""
