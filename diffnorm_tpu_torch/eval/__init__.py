"""eval of the PyTorch port (see diffnorm_tpu/eval)."""
