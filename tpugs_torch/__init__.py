"""tpugs_torch — the PyTorch + CUDA port of ``tpugs`` for NVIDIA Hopper.

The JAX package ``tpugs`` is the reference; this package computes the same
results on an H100. Plain tensor code is PyTorch; every Pallas kernel that
``tpugs`` runs on the main path has a CUDA C++ counterpart in ``csrc/``,
built with ``nvcc`` at first use (``kernels/build.py``) and wrapped in
``raster/kernels.py`` (lift) or ``raster/train.py`` (train step) beside a
plain PyTorch twin that the CPU tests use.

Layout mirrors ``tpugs`` so each module's counterpart is easy to find:

  core/      scene (raw parameterisation + activations), cameras, devices
  io/        COLMAP, PLY, checkpoint and compression readers and writers; the
             ``cv2`` image reader
  native/    the C++ COLMAP parser (g++, ctypes) beside the pure readers
  apps/      the CLIs: back-projection (load, prune, verify, lift, save),
             segmentation and edits, the compressed lift, the codec's
             training, PCA renders, affordance transfer, training and its
             supervisor, the dataset downloader, the at-scale dataset
             writer, the weight-conversion report; the interactive apps: the
             viewer, click-and-segment, the language-driven editor and its
             LLM backends
  utils/     synthetic scenes, orbit rigs and COLMAP models (bit-identical
             to tpugs'), Morton order, the function-signature CLI, CUDA-event
             timing, profiling (roofline models at the H100's peaks, the
             stage timer, torch.profiler traces and their idle share)
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
  query/     text and exemplar queries, 3D masks and edits, exact k-NN,
             affordance transfer and its evaluation
  codec/     the linear 512 -> 16 feature codec and its Adam training
  viz/       GIF frames, mask overlays and PCA renders (files by io/images.py:
             the port's GIF encoder, cv2 for PNGs)
  train/     config, metrics, the strategies (Default, MCMC), the trainer
             (step, refine, pose and appearance, eval, checkpoints), the
             modules, LPIPS, the COLMAP dataset, normalisation,
             trajectories and the live viewer
  experiments/ the reduce experiments S1 (scatter writes) and S2 (reduce tail),
             the phases tools, the LSeg encoder's post step, the lift's
             stage profiler, the sharded programs on one device, gather
             locality (Morton order against the default)
  dist/      runs over several devices on ``torch.distributed`` (NCCL on
             CUDA, gloo on the CPU): meshes, the sharded lift, the sharded
             train step, its chunk and refine, CPU ranks for tests, the dry
             run
  kernels/   the nvcc build of ``csrc/*.cu``
  convert.py numpy state in, port state out (scenes, cameras, codecs, the
             Flax encoders' params)

Nothing here imports ``jax`` or ``tpugs``; only the tests import both.

The scripts under ``scripts/`` were ported in ROADMAP queue A item 8, the
last item: the at-scale dataset writer (``apps/make_atscale_dataset.py``),
the gather-locality experiment (``experiments/gather_locality.py``) and the
weight-conversion report (``apps/convert_weights.py``); images are read
with ``cv2`` (``io/images.py``).
"""

from tpugs_torch.core.camera import Camera  # noqa: F401
from tpugs_torch.core.scene import GaussianScene  # noqa: F401
from tpugs_torch.raster.api import rasterize  # noqa: F401
