"""Queries and edits of a lifted field. Counterpart: ``tpugs/query/__init__.py``."""

from tpugs_torch.query.text import get_mask3d, score_features  # noqa: F401
from tpugs_torch.query.masks import apply_mask3d  # noqa: F401
from tpugs_torch.query.knn import knn_search, transfer_labels  # noqa: F401
