"""The distributed layer: a device mesh and the sharded engines
(``mesh.py``, ``shard_engine.py``, ``shard_adaptive.py``)."""
