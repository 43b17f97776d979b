"""The yardstick's peaks and roofline arithmetic, frozen here.

Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, 700 W):
495 TFLOP/s on the TF32 tensor cores and 3.35 TB/s of HBM bandwidth. Every
FLOP share of the benchmark counts the work of the model or of the kernel
once (2 x multiply-adds, from shapes) against the TF32 tensor-core peak, so
no faster float32 implementation of the same arithmetic can read above 100%:
the 67 TFLOP/s FP32 peak and a 3xTF32 count would both describe one
implementation rather than the work.
"""

TF32_FLOPS = 495e12        # FLOP/s, tensor cores, dense
HBM_BYTES = 3.35e12        # bytes/s
F32 = 4                    # bytes a float32 value


def bound_s(flops, nbytes):
    """The least time the card could take for ``flops`` and ``nbytes``:
    the larger of the two at their peaks; returns (seconds, what bounds
    it)."""
    t_op, t_mem = flops / TF32_FLOPS, nbytes / HBM_BYTES
    return (t_op, "operations") if t_op >= t_mem else (t_mem, "bytes")


def conv3x3_work(n, cin, z, x, y, cout, dx, dy):
    """FLOPs and bytes of one valid (3,3,3) conv at z-dilation 1 and
    xy-dilation (dx, dy) with bias and ReLU (a K1 launch): each input value
    read once, the weights and bias once, each output written once."""
    zo, xo, yo = z - 2, x - 2 * dx, y - 2 * dy
    out = n * cout * zo * xo * yo
    flops = 2 * cin * 27 * out
    nbytes = F32 * (n * cin * z * x * y + cout * cin * 27 + cout + out)
    return flops, nbytes
