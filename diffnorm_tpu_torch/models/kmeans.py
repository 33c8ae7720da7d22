"""K-means unit quantization: argmin ||x - c||^2 as one matrix product.

The port's copy of diffnorm_tpu/models/kmeans.py: centroids from `.npy` (or
a joblib sklearn KMeans, where joblib is installed), units as
argmin(-2 x.c + |c|^2) from a float32 product with int32 ids, and codebooks
trained by mini-batch Lloyd's iterations on the device. JAX computes the
product outside any Pallas kernel, so it is `torch.matmul` here. `kmeans_fit`
draws its initial centroids and mini-batches with the same
`np.random.default_rng(seed)` calls as JAX's, so both pick the same rows.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from diffnorm_tpu_torch.device import resolve_device


def load_centroids(path: str) -> np.ndarray:
    """[K, D] float32 centroids from a .npy file, else from a joblib dump of
    an sklearn KMeans (needs joblib)."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    import joblib

    return np.asarray(joblib.load(path).cluster_centers_, dtype=np.float32)


def save_centroids(path: str, centroids: np.ndarray) -> None:
    """.npy, else a joblib dump of an sklearn KMeans (needs both)."""
    if path.endswith(".npy"):
        np.save(path, centroids)
        return
    import joblib
    from sklearn.cluster import KMeans

    km = KMeans(n_clusters=centroids.shape[0])
    km.cluster_centers_ = centroids.astype(np.float64)
    km._n_threads = 1
    joblib.dump(km, path)


def kmeans_predict(feats: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """feats [..., T, D], centroids [K, D] -> int32 unit ids [..., T]."""
    centroids = centroids.float()
    c_sq = centroids.square().sum(-1)
    scores = -2.0 * torch.matmul(feats.float(), centroids.T) + c_sq
    return scores.argmin(-1).to(torch.int32)


def _lloyd_step(feats: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """One Lloyd's iteration over a [N, D] batch; a cluster that gets no
    point keeps its centroid."""
    assign = kmeans_predict(feats, centroids).long()
    k = centroids.shape[0]
    sums = torch.zeros_like(centroids).index_add_(0, assign, feats.float())
    counts = torch.bincount(assign, minlength=k).to(centroids.dtype)[:, None]
    return torch.where(counts > 0, sums / counts.clamp(min=1.0), centroids)


def kmeans_fit(feats: np.ndarray, num_clusters: int, iters: int = 50,
               batch_size: int = 65536, seed: int = 0,
               device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """Mini-batch Lloyd's on `device` (the card unless the CPU is asked
    for). feats: [N, D] on the host. Returns [K, D] float32."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    init_idx = rng.choice(len(feats), size=num_clusters, replace=False)
    centroids = torch.as_tensor(feats[init_idx], dtype=torch.float32, device=device)
    n = len(feats)
    for _ in range(iters):
        idx = rng.choice(n, size=min(batch_size, n), replace=False)
        batch = torch.as_tensor(feats[idx], dtype=torch.float32, device=device)
        centroids = _lloyd_step(batch, centroids)
    return centroids.cpu().numpy()
