"""Runs over several devices on ``torch.distributed``: meshes, the sharded
lift, the sharded train step, its chunk and refine (``mesh.py``,
``shard.py``), CPU ranks for tests (``spawn.py``) and the dry run
(``dryrun.py``). Counterpart: ``tpugs/dist``."""
