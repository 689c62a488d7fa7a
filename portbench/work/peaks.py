"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3; NVIDIA's data
sheet, dense rates, at the full 700 W power limit).  A run reports the
card's name, and PERF.md its power limit, beside every share of these."""
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
