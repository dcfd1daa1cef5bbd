"""openmvg_torch — the PyTorch/CUDA port of openmvg_tpu for NVIDIA Hopper.

The package mirrors openmvg_tpu's layout so each module has one
counterpart there:

  core/      index types and sentinels
  csrc/      hand-written CUDA kernels (K1 two_nn.cu, K2 seg_sum.cu, K3
             smatvec.cu) and the host C++ of the f64 polish and of TBMR's
             component tree (native.cpp), built at first use
  geometry/  SO(3), poses, similarity alignment, geodesy
  io/        openMVG file formats (sfm_data.json, .feat/.desc, matches.*.bin,
             PNG, PLY, Strecha ground truth) and the converter from the
             reference package's records
  models/    the six camera models
  ops/       SIFT, AKAZE, FAST / KLT, MSER, TBMR, LIOP, DIPOLE, the image
             toolbox, equirectangular resampling, descriptor matching (K1),
             fundamental / essential / resection solvers, triangulation,
             AC-RANSAC, small dense
             linear algebra, the segment sum (K2), the fused S-matvec (K3),
             rotation and translation averaging, triplet translations
  sfm/       the Scene record, describers, robust estimation, geometric
             filter, tracks, bundle adjustment, f64 polish, filters, the
             incremental and global engines, colorisation, evaluation,
             monocular VO
  parallel/  torch.distributed runtime (one process a rank), meshes,
             observation- and point-sharded bundle adjustment, ring
             matching, the partitioner and the scaling harness
  utils/     pair graphs, device selection, synthetic datasets, build,
             stage timers, deadline
  cli.py     init / features / pairs / matches / filter / sfm / color /
             eval / pipeline, and the other commands listed in its
             docstring (cubify, vo, refine -d N, scaling-bench, ...)

It imports torch, numpy and scipy; never jax and never openmvg_tpu.
"""

import torch as _torch

__version__ = "0.1.0"

# Full-f32 numerics, the policy openmvg_tpu sets for its matmuls.  cuDNN
# runs f32 convolutions in TF32 by default, and SIFT's difference of
# Gaussians is a difference of two such convolutions: reduced precision
# leaves noise of the size of the DoG signal on fine texture, which
# multiplies the detections.  The geometric solvers (normal matrices
# and batched 3x3 products) lose their conditioning the same way.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
