"""Small helpers of the PyTorch port (see diffnorm_tpu/utils)."""
