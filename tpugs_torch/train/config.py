"""Trainer configuration. Counterpart: ``tpugs/train/config.py``
(``TrainConfig``, the reference's ``Config`` dataclass), with the same
fields, defaults and ``adjust_steps``.

``Trainer`` raises on any field of ``NOT_READ`` set away from its default,
so that such a setting is not ignored. The ``pallas_*`` fields keep their
names and configure the port's train kernels (B4/B5): tile size,
gradient-row dtype and early-exit threshold. As in tpugs, ``data_factor``,
``result_dir``, ``test_every``, ``patch_size``, ``lpips_net`` and
``disable_viewer`` are read by nothing: the app takes the first three as
its own arguments.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class TrainConfig:
    # data
    data_dir: str = "./data/garden"
    data_factor: int = 4
    result_dir: str = "./results/garden"
    test_every: int = 8
    patch_size: Optional[int] = None
    normalize_world_space: bool = True

    # training
    max_steps: int = 30_000
    batch_size: int = 1
    steps_scaler: float = 1.0
    eval_steps: List[int] = dataclasses.field(default_factory=lambda: [7_000, 30_000])
    save_steps: List[int] = dataclasses.field(default_factory=lambda: [7_000, 30_000])

    # model
    init_type: str = "sfm"  # sfm | random
    init_num_pts: int = 100_000
    init_extent: float = 3.0
    sh_degree: int = 3
    sh_degree_interval: int = 1000
    init_opa: float = 0.1
    init_scale: float = 1.0
    feature_dim: int = 128  # per-Gaussian latent feature size
    feature_out_dim: int = 512  # teacher feature size (LSeg 512)

    # loss weights
    ssim_lambda: float = 0.2
    feature_lambda: float = 1.0
    teacher_dtype: str = "bfloat16"  # dtype of the teacher target ("float32": exact)
    depth_loss: bool = False
    depth_lambda: float = 0.01
    opacity_reg: float = 0.0
    scale_reg: float = 0.0
    random_bkgd: bool = True  # random background against transparency

    # camera pose optimization
    pose_opt: bool = False
    pose_opt_lr: float = 1e-5
    pose_opt_reg: float = 1e-6  # weight decay
    pose_noise: float = 0.0  # synthetic extrinsics noise (pose-opt testing)

    # appearance optimization
    app_opt: bool = False
    app_embed_dim: int = 16
    app_opt_lr: float = 1e-3
    app_opt_reg: float = 1e-6

    # eval extras
    lpips_net: str = "alex"  # alex | vgg
    compression: str = ""  # "png" -> PNG-compression eval

    # learning rates
    means_lr: float = 1.6e-4
    scales_lr: float = 5e-3
    opacities_lr: float = 5e-2
    quats_lr: float = 1e-3
    sh0_lr: float = 2.5e-3
    shN_lr: float = 2.5e-3 / 20
    features_lr: float = 2.5e-3
    conv_lr: float = 2.5e-3

    # densification
    strategy: str = "default"  # default | mcmc | none
    refine_start_iter: int = 500
    refine_stop_iter: int = 15_000
    refine_every: int = 100
    grow_grad2d: float = 0.0002
    # grow on the per-pixel-abs screen gradient (gsplat's absgrad) instead
    # of the signed sum; gsplat pairs it with a ~4x higher grow_grad2d
    absgrad: bool = False
    grow_scale3d: float = 0.01
    prune_opa: float = 0.005
    prune_scale3d: float = 0.1
    reset_every: int = 3000
    capacity_multiple: int = 0  # pad N to a multiple after each refine (0: exact)

    # rendering
    near_plane: float = 0.01
    far_plane: float = 1e10
    antialiased: bool = False
    # "auto" and "pallas": the train kernels (B4/B5) on CUDA tensors, their
    # plain twins on CPU tensors, at pallas_trans_eps; "tiled": the same
    # kernels with no early exit at TileConfig's tile (render_tiled)
    raster_engine: str = "auto"
    pallas_tile_size: int = 0  # 0 = auto: 32 for >= 2^20-pixel renders, else 16
    pallas_size_margin: float = 1.2  # the reference's static buckets (NOT_READ)
    pallas_contrib_dtype: str = "float32"  # gradient-row dtype: float32 | bfloat16
    pallas_trans_eps: float = 1e-4  # early-exit threshold; 0.0 composites every block

    # misc
    seed: int = 42
    tb_every: int = 100
    disable_viewer: bool = True

    def adjust_steps(self, factor: Optional[float] = None) -> "TrainConfig":
        """Scale every schedule by ``steps_scaler`` (or ``factor``)."""
        f = self.steps_scaler if factor is None else factor
        if f == 1.0:
            return self
        return dataclasses.replace(
            self,
            max_steps=int(self.max_steps * f),
            eval_steps=[int(s * f) for s in self.eval_steps],
            save_steps=[int(s * f) for s in self.save_steps],
            sh_degree_interval=int(self.sh_degree_interval * f),
            refine_start_iter=int(self.refine_start_iter * f),
            refine_stop_iter=int(self.refine_stop_iter * f),
            refine_every=int(self.refine_every * f),
            reset_every=int(self.reset_every * f),
        )


# Fields the port's Trainer never reads -> what reads them in tpugs.
NOT_READ = {
    "pallas_size_margin": "the static size buckets (the port's plans are exact)",
}


def unread_settings(cfg: TrainConfig) -> List[str]:
    """Fields of ``NOT_READ`` that ``cfg`` sets away from their defaults."""
    default = TrainConfig()
    return [k for k in NOT_READ if getattr(cfg, k) != getattr(default, k)]
