"""NVIDIA H100 SXM (80 GB HBM3) data-sheet peaks, dense, at its 700 W limit."""

PEAK_FLOPS = {
    "bf16": 989e12,
    # float32 products are held to TF32's tensor-core rate, the card's fastest for
    # float32 inputs (the port's float32 kernels do three bf16 products on the tensor
    # cores; float32 outside them is 67e12)
    "f32": 495e12,
}
PEAK_BYTES = 3.35e12  # HBM3, bytes/s
ITEMSIZE = {"bf16": 2, "f32": 4}


def bound_s(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """The least time of a call: the larger of its operations over the peak rate of
    `dtype` and its bytes over the memory rate; and which of the two it is."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
