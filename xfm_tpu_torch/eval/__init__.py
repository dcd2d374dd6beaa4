"""Evaluation metrics of the port: VQA accuracy."""
