"""Ops: plain attention, the attention kernels (K1, K2, K3), the fused
(residual +) LayerNorm (K4), the fused activation-prologue MLP matmul (K5),
their shared build and launch counting, the rel-pos bias, patches and
activations."""
