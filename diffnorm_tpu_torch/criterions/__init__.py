"""Training criterions of the PyTorch port (see diffnorm_tpu/criterions):
the speech VAE's, the latent normalizer's and NAR S2UT's, on tensors."""
