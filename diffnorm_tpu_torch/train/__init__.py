"""Training of the PyTorch port (see diffnorm_tpu/train): fairseq Adam, the
inverse_sqrt schedule, the trainer and the port's checkpoints."""
