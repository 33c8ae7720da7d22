"""Training of the PyTorch port (see diffnorm_tpu/train): JAX's optimizers
and LR schedules on tensors, EMA, the trainer, metric aggregation and
progress sinks, and the port's checkpoints."""
