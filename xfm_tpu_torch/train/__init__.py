"""Optimizer, schedule, train step and checkpoints."""
