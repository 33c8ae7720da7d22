"""Training criterions of the PyTorch port (see diffnorm_tpu/criterions):
the speech VAE's and the latent normalizer's, on tensors."""
