"""Published peaks of one NVIDIA H100 80GB HBM3 (SXM, NVIDIA's data
sheet, at its 700 W limit), which the roofline shares divide by."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
