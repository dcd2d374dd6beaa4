"""On-device image normalization."""
