"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates at the
700 W limit)."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12,
         # three TF32 products per float32 product (split operands)
         "3xtf32": 495e12 / 3}


def least_seconds(nbytes: float, ops: float, precision: str) -> float:
    """The least time the card could take for this work."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FLOPS[precision])
