"""Metrics of the port (counterpart of bem_tpu/metrics)."""
