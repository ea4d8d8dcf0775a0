"""Host utilities of the port (counterpart of bem_tpu/utils): image IO and
the /16 condition resize, options and the CLIs' argument parsing,
checkpoints (read and written in flax's layout), logging, experiment
directories, the disk file client, label noise, colour conversions and
the histogram condition, on numpy and the standard library only."""
