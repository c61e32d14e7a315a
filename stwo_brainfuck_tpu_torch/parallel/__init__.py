"""Multi-device proving over a mesh of torch devices (one process).

Counterpart of ``stwo_brainfuck_tpu/parallel/``: ``mesh.py`` (the mesh, its
collectives and the sharded-array type), ``fft_sharded.py``,
``merkle_sharded.py``, ``sharded.py`` (one component's row-sharded step)
and ``prove.py`` (``ShardedOps``, the backend ``air.prove_brainfuck(...,
mesh=)`` routes through). Multi-host proving is not ported yet.
"""
