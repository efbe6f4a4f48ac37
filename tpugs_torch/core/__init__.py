from tpugs_torch.core.camera import Camera  # noqa: F401
from tpugs_torch.core.device import resolve_device  # noqa: F401
from tpugs_torch.core.scene import GaussianScene  # noqa: F401
