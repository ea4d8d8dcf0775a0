"""The serving pipeline of the port (counterpart of bench.py / bem_tpu/enhancement)."""
