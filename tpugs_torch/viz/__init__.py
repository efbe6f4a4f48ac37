"""GIF and PCA renders of scenes and fields. Counterpart: ``tpugs/viz/__init__.py``."""

from tpugs_torch.viz.gif import render_to_gif, render_mask_2d_to_gif  # noqa: F401
from tpugs_torch.viz.pca import feature_pca, render_pca  # noqa: F401
