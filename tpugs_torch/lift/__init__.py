from tpugs_torch.lift.prune import (  # noqa: F401
    prune_by_gradients,
    test_proper_pruning,
    verify_pruning_equivalence,
)
from tpugs_torch.lift.backproject import create_feature_field  # noqa: F401
