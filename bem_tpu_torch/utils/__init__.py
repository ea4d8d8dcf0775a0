"""Host utilities of the port (counterpart of bem_tpu/utils): image IO,
options, checkpoints, colour conversions, MATLAB resize and the histogram
condition, on numpy and the standard library only."""
