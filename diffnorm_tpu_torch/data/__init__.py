"""data of the PyTorch port (see diffnorm_tpu/data)."""
