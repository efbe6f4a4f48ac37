"""The linear feature codec. Counterpart: ``tpugs/codec/__init__.py``."""

from tpugs_torch.codec.linear import LinearCodec, train_codec  # noqa: F401
