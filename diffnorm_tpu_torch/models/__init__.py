"""models of the PyTorch port (see diffnorm_tpu/models)."""
