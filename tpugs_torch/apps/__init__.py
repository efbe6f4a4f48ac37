"""Command-line entry points. Counterpart: ``tpugs/apps``."""
