"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  The port runs its f32 matmuls
with TF32 off, so its operations count against the f32 rate outside
the tensor cores."""
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
