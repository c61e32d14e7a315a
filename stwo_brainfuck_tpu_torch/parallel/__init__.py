"""Multi-device proving: one process over a mesh of torch devices, or one
process per shard over torch.distributed.

Counterpart of ``stwo_brainfuck_tpu/parallel/``: ``mesh.py`` (the two mesh
types, their collectives and the sharded-array type), ``multihost.py``
(joining the process group, ``global_mesh``), ``fft_sharded.py``,
``merkle_sharded.py``, ``sharded.py`` (one component's row-sharded step)
and ``prove.py`` (``ShardedOps``, the backend ``air.prove_brainfuck(...,
mesh=)`` routes through).
"""
