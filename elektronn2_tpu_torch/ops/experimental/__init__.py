"""ops.experimental — port of ``elektronn2_tpu/ops/experimental``: kernels
no production route calls (``dilated_conv``, K5)."""
