"""tpugs_torch — the PyTorch + CUDA port of ``tpugs`` for NVIDIA Hopper.

The JAX package ``tpugs`` is the reference; this package computes the same
results on an H100. Plain tensor code is PyTorch; every Pallas kernel that
``tpugs`` runs on the main path has a CUDA C++ counterpart in ``csrc/``,
built with ``nvcc`` at first use (``kernels/build.py``) and wrapped in
``raster/kernels.py`` (lift) or ``raster/train.py`` (train step) beside a
plain PyTorch twin that the CPU tests use.

Layout mirrors ``tpugs`` so each module's counterpart is easy to find:

  core/      scene (raw parameterisation + activations), cameras, devices
  io/        COLMAP, PLY, checkpoint and compression readers and writers
  native/    the C++ COLMAP parser (g++, ctypes) beside the pure readers
  apps/      the back-projection CLI (load, prune, verify, lift, save)
  utils/     synthetic scenes, orbit rigs and COLMAP models (bit-identical
             to tpugs'), Morton order, the function-signature CLI
  raster/    projection, SH, binning, per-view plan and pack, the lift
             kernels (render, adjoint, reduce; the opt-in scatter engine's
             adjoint_scatter and stripe_sum), the per-view calls of them,
             the XLA reduce engine, the differentiable train render (kernels
             train_fwd, train_bwd), the tiled render and adjoint on them, the
             dense oracle and the gsplat-shaped ``rasterize`` API
  encoders/  synthetic pixelwise encoders, the ViT encoders (LSeg, DINOv2,
             the CLIP text tower; ``jax.image.resize``'s semantics in
             ``resize.py``), their checkpoint loaders and the registry
  lift/      the fused multi-view back-projection loop, the split-encoder
             lift, the eager lift (``create_feature_field``) and gradient
             pruning
  train/     config, metrics, strategy "none" and the trainer's step
  experiments/ the reduce experiments S1 (scatter writes) and S2 (reduce tail),
             the phases tools, the LSeg encoder's post step
  kernels/   the nvcc build of ``csrc/*.cu``
  convert.py numpy state in, port state out (scenes, cameras, the Flax
             encoders' params)

Nothing here imports ``jax`` or ``tpugs``; only the tests import both.
"""

from tpugs_torch.core.camera import Camera  # noqa: F401
from tpugs_torch.core.scene import GaussianScene  # noqa: F401
from tpugs_torch.raster.api import rasterize  # noqa: F401
