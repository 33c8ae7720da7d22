"""PyTorch/CUDA port of diffnorm_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (models/, ops/, data/, cli/) and imports
neither JAX nor anything of `diffnorm_tpu`. The kernels that the JAX package
wrote in Pallas for the TPU are CUDA C++ sources under `csrc/`, built with
nvcc on first use (`ops/_build.py`). Ported so far: the DiffNorm DDIM
normalization path in bf16 and int8, on the int8 kernel routes and on JAX's
static-scale module route (`models/diffusion.py:ddim_sample`,
`python -m diffnorm_tpu_torch.cli.diff_norm_synthesis`), the S2ST serving
chain for inference (`generate/s2st.py:s2st_generate`,
`python -m diffnorm_tpu_torch.cli.s2st`), training of the speech VAE, the
latent normalizer over it and the NAR S2UT translator
(`python -m diffnorm_tpu_torch.cli.train`), and the prep stage: mHuBERT
features and k-means units (`models/{hubert,kmeans}.py`,
`python -m diffnorm_tpu_torch.cli.prepare`, `cli.get_manifest`).
"""
