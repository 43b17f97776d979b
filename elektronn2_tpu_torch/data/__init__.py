"""data — KNOSSOS datasets, tracing runtime and skeleton I/O.

Port of parts of ``elektronn2_tpu/data``: ``knossos_array`` (the jax-free
``KnossosArray``, ``KnossosArrayMulti`` and ``save_knossos``, with the C++
cube core ``knossos_core.cpp`` behind ``_knossos_native``), ``skeleton``
(the jax-free ``Trace`` and KNOSSOS export) and ``tracing_utils``
(``DeviceTracer``, ``ShotgunRegistry``). Nothing is imported here: import
the submodules.
"""
