"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): the yardstick of every roofline and mfu share.
A run states the card's power limit beside them."""

FP32_FLOPS_PER_S = 67e12      # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12     # 80 GB of HBM3
