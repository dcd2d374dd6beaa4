"""xfm_tpu_torch: the PyTorch/CUDA port of xfm_tpu for NVIDIA Hopper.

Held against the JAX package `xfm_tpu`, which it never imports. Entry points
run on the card (`device="cuda"`) unless the caller asks for the CPU.
"""
