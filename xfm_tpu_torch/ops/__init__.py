"""Ops: plain attention, the packed-qkv Hopper attention kernel (K1), the
rel-pos bias, patches and activations."""
