"""Quantization substrate of the port."""
