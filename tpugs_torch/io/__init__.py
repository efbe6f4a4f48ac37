"""Scene, checkpoint and COLMAP I/O. Counterpart: ``tpugs/io``."""
