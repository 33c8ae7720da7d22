"""Training criterions of the PyTorch port (see diffnorm_tpu/criterions):
the speech VAE's and the HuBERT VAE's, the latent normalizer's discrete and
continuous DDPM losses, NAR S2UT's and AR S2UT's (the text models' too),
the TTS models' and the Levenshtein transformer's, on tensors."""
