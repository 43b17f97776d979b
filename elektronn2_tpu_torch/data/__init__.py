"""data — tracing runtime and skeleton I/O.

Port of parts of ``elektronn2_tpu/data``: ``skeleton`` (the jax-free
``Trace`` and KNOSSOS export) and ``tracing_utils`` (``DeviceTracer``,
``ShotgunRegistry``). Nothing is imported here: import the submodules.
"""
