"""ops of the PyTorch port (see diffnorm_tpu/ops)."""
