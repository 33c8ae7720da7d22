"""cli of the PyTorch port (see diffnorm_tpu/cli)."""
