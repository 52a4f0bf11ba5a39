"""presight-tpu in PyTorch, with hand-written CUDA kernels for NVIDIA
Hopper (sm_90a): the city-tile NeRF (training, serving and prior
extraction, for the reference architecture and the -tpu profile), and the
stage-3 models that consume its priors: BEVDet-Occ occupancy (training and
serving) and StreamMapNet online mapping (serving).

The JAX package ``presight_tpu`` is the reference; this package imports
torch and never jax, and nothing of ``presight_tpu``. Modules mirror the
JAX package's layout:

configs   mirrors of the config dataclasses, the 73 named method configs
          (method_configs) and config.yml / CLI overrides (config_io)
bridge    JAX parameter trees <-> the port's tensors (same layouts)
kernels   build, load, launch and launch counts of the CUDA kernels in
          csrc/, and the one rule that picks a kernel or its plain version
native    host libraries built by g++: the voxel accumulator and the JPEG
          codec (native/jpeg.py)
ops       hash encoding (K1, K1b, K5), grouped MLP (K2, K2b), volume
          rendering (K3, K3b), samplers, losses, rays, math
fields    expert routing, main field, proposal fields and cached grid (K4),
          sky field
models    NerfactoNuscMS: train and eval forward, losses, depth-only
          forward, point and field queries; the shared layers and the
          prior fusion of the stage-3 models
data      cameras, the dataparser (with its k-means), image loading, the
          chunked dataset and data manager, device stores, the synthetic
          fixture
engine    Trainer (from disk or in memory) and train step, checkpoints,
          ImageRenderer and image metrics, reference-checkpoint import
prior     prior extraction to the city-prior pickle, and the priors'
          crop and voxelization for the stage-3 models
occupancy BEVDet-Occ: backbones, the LSS view transformer with the stereo
          cost volume (S2), the lift-splat (S1, S1b), batched inference
mapping   StreamMapNet: the BEVFormer encoder with DCNv2, the ConvGRU
          memory, the map head and its top-k hand-off, deformable
          sampling (S3)
utils     PSNR / SSIM, occupancy metrics, the event writer, EMA, scoped
          precision settings, spans and counters (profiler)
scripts   the CLIs: train, eval, render, export, extract_priors, and
          train_occ (occupancy training and evaluation)

``kernels.use_plain`` is the one rule that picks a hand kernel or its plain
version: every wrapper runs its plain PyTorch (or numpy) version on CPU
tensors and inside ``kernels.plain_versions()``, the scope a check on the
card runs them under, and launches its kernel otherwise.
"""
