from tpugs_torch.raster.api import rasterize  # noqa: F401
