"""generate of the PyTorch port (see diffnorm_tpu/generate)."""
