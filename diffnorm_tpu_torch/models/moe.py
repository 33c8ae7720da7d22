"""The BASE mixture-of-experts layer with balanced routing (the port of
diffnorm_tpu/models/moe.py; reference fairseq/modules/base_layer.py and
libbase's balanced_assignment): every token goes to exactly one expert FFN,
and every expert takes the same number of tokens.

* `balanced_assignment_host`: libbase's k-jobs-per-worker auction
  (Bertsekas), in numpy on the host, the same algorithm JAX calls in its
  native library.
* `sinkhorn_routing`: the on-device router. Sinkhorn-normalize the scores
  toward doubly stochastic, then the experts in turn claim their top n / E
  unclaimed tokens. A tie goes to the lower token index, as lax.top_k
  breaks it: the claim is a stable descending sort, made explicit because
  torch.topk promises no order among equals.
* `BaseLayer`: route, a stable sort of the tokens by expert, each expert's
  ReLU FFN as one batched product over [E, n / E, dim], the results put
  back, gated by the sigmoid of the chosen expert's raw score. The
  parameters are float32; the products run in `dtype`. Under tensor
  parallelism the experts split over the model axis (JAX
  sharding_rules.py:41-44): the routing is computed alike on every rank,
  each rank runs its experts on the tokens routed to them, and the outputs
  are summed over the model group.

The expert weights `experts_w1` [E, dim, ffn], `experts_w2` [E, ffn, dim]
and `expert_centroids` [E, dim] are plain parameters under JAX's names and
layouts, so `weights.from_jax_params` carries them as they are (only a
leaf named `kernel` is transposed).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from diffnorm_tpu_torch.parallel.mesh import copy_in, reduce_out


def balanced_assignment_host(scores: np.ndarray) -> np.ndarray:
    """scores [n_tokens, n_experts] (n_tokens a multiple of n_experts) ->
    [n_tokens] int64 expert ids, n / E a expert."""
    scores = np.ascontiguousarray(scores, np.float32)
    n, e = scores.shape
    if n % e:
        raise ValueError(f"{n} tokens do not divide evenly among {e} experts")
    k, max_iterations = n // e, 100
    epsilon = max((scores.max() - scores.min()) / 50.0, 1e-4)
    max_value = float(scores.max())
    wj = np.ascontiguousarray(scores.T, np.float32)  # [e, n]
    value = wj.copy()
    cost = np.zeros(n, np.float32)
    bid_indices = np.zeros(0, np.int64)
    rows, cols = np.arange(e)[:, None], np.arange(n)
    counter = 0
    while True:
        bids = np.zeros((e, n), np.float32)
        # each worker's top k + 1 jobs, ties to the lower index
        order = np.lexsort((np.broadcast_to(cols, (e, n)), -value), axis=1)[:, :k + 1]
        kth = value[rows, order[:, k:]]
        inc = value[rows, order[:, :k]] - kth + epsilon
        np.put_along_axis(bids, order[:, :k], inc.astype(np.float32), axis=1)
        if 0 < counter < max_iterations:
            bids.reshape(-1)[bid_indices] = epsilon  # the retention bids
        high_bidders = bids.argmax(axis=0)  # ties to the lowest worker
        high_bids = bids[high_bidders, cols]
        if (high_bids > 0).all():
            break
        cost += high_bids
        value = wj - cost[None, :]
        have = high_bids > 0
        bid_indices = (high_bidders[have] * n + cols[have]).astype(np.int64)
        value.reshape(-1)[bid_indices] = (max_value if counter < max_iterations
                                          else wj.reshape(-1)[bid_indices])
        counter += 1
    out = np.zeros(n, np.int64)
    for w in range(e):
        out[order[w, :k]] = w
    return out


def sinkhorn_routing(scores: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """scores [N, E] -> expert ids [N] (int64), N / E a expert."""
    n, e = scores.shape
    cap = n // e
    log_p = scores.float()
    for _ in range(iters):
        log_p = log_p - torch.logsumexp(log_p, dim=1, keepdim=True)
        log_p = log_p - torch.logsumexp(log_p, dim=0, keepdim=True)
    taken = torch.zeros(n, dtype=torch.bool, device=scores.device)
    expert_id = torch.zeros(n, dtype=torch.long, device=scores.device)
    for j in range(e):
        col = log_p[:, j].masked_fill(taken, -torch.inf)
        idx = torch.sort(col, descending=True, stable=True).indices[:cap]
        taken[idx] = True
        expert_id[idx] = j
    return expert_id


class BaseLayer(nn.Module):
    tp_ready = True
    tp_axis = None

    def __init__(self, dim: int, ffn_dim: int, num_experts: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.num_experts, self.dtype = dim, num_experts, dtype
        self.expert_centroids = nn.Parameter(torch.randn(num_experts, dim) * 0.02)
        # lecun normal over flax's fan-in of an [E, in, out] kernel, in * E
        self.experts_w1 = nn.Parameter(torch.randn(num_experts, dim, ffn_dim)
                                       / (dim * num_experts) ** 0.5)
        self.experts_w2 = nn.Parameter(torch.randn(num_experts, ffn_dim, dim)
                                       / (ffn_dim * num_experts) ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, dim], tokens first (N % E == 0) -> [N, dim] in x's type."""
        n, e = x.shape[0], self.num_experts
        scores = x.float() @ self.expert_centroids.float().T
        expert_id = sinkhorn_routing(scores)
        order = torch.argsort(expert_id, stable=True)
        mine, x_in, axis = order.reshape(e, n // e), x, self.tp_axis
        if axis is not None:  # this rank's experts and the tokens routed to them
            lo, hi = axis.block(e)
            mine = mine[lo:hi]
            x_in = copy_in(x, axis)
        mine = mine.reshape(-1)
        routed = x_in[mine].reshape(-1, n // e, self.dim).to(self.dtype)
        h = torch.relu(torch.bmm(routed, self.experts_w1.to(self.dtype)))
        h = torch.bmm(h, self.experts_w2.to(self.dtype)).reshape(-1, self.dim)
        unrouted = torch.zeros(n, self.dim, dtype=h.dtype, device=h.device).index_copy(0, mine, h)
        if axis is not None:
            unrouted = reduce_out(unrouted, axis)
        gate = torch.sigmoid(scores.gather(1, expert_id[:, None])).to(x.dtype)
        return x + gate * unrouted.to(x.dtype)
