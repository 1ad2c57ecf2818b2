"""DBSCAN clustering of Gaussian primitives under the 2-Wasserstein metric
(counterpart of ``gstex_tpu/tools/dbscan.py``, the reference's standalone
``dbscan_clustering/`` tool).

The squared 2-Wasserstein distance between 3D Gaussians is
``‖μ1−μ2‖² + tr(Σ1+Σ2−2(Σ2^½ Σ1 Σ2^½)^½)``, with a PSD square root by
``torch.linalg.eigh`` (Σ2^½ once a Gaussian, the outer root once a pair,
in batches cuSOLVER takes);
eps comes from a k-distance percentile; DBSCAN's
neighbour queries are brute force in blocks of query rows against every
Gaussian on the tensors' device (the card unless the caller gives CPU
tensors), and the cluster expansion is a breadth-first search on the host
over those chunks' neighbour masks, in the JAX package's order, so both
label the same clusters alike. No scikit-learn.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.quat import quat_to_rotmat
from ..utils.device import resolve_device

NOISE = -1
UNVISITED = -2
# 3x3 matrices one batched eigh takes: on the H100, cuSOLVER's batched
# solver refuses batches of 32768 and more (its buffer-size query
# returns an invalid value), so larger batches go in pieces (each
# matrix's decomposition is the same whatever its piece)
EIGH_BATCH = 1 << 14


def make_covariance_3d(log_scales: torch.Tensor,
                       quats: torch.Tensor) -> torch.Tensor:
    """(N, 2|3) log-scales and (N, 4) wxyz quats -> (N, 3, 3) covariances.
    As the reference: the first two axes exp(log_scale) clamped at 1e-9,
    the third 1e-5 times their mean."""
    s = torch.clamp(torch.exp(log_scales[..., :2]), min=1e-9)
    s3 = 1e-5 * torch.mean(s, dim=-1, keepdim=True)
    scale = torch.cat([s, s3], dim=-1)
    r = quat_to_rotmat(quats)
    return torch.einsum("...ij,...j,...kj->...ik", r, scale * scale, r)


def sqrtm_psd_3x3(mat: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    flat = mat.reshape(-1, 3, 3)
    parts = [torch.linalg.eigh(flat[i:i + EIGH_BATCH])
             for i in range(0, flat.shape[0], EIGH_BATCH)]
    e = torch.cat([a for a, _ in parts]).reshape(mat.shape[:-1])
    v = torch.cat([b for _, b in parts]).reshape(mat.shape)
    se = torch.sqrt(torch.clamp(e, min=eps))
    return torch.einsum("...ij,...j,...kj->...ik", v, se, v)


def wasserstein2_sq(mu1, cov1, mu2, cov2, sqrt2=None) -> torch.Tensor:
    """Squared 2-Wasserstein distance; broadcasts over leading dims.
    ``sqrt2``, given, is ``sqrtm_psd_3x3(cov2)``, computed once a
    Gaussian rather than once a pair."""
    mean_term = torch.sum((mu1 - mu2) ** 2, dim=-1)
    if sqrt2 is None:
        sqrt2 = sqrtm_psd_3x3(cov2)
    inner = sqrt2 @ cov1 @ sqrt2.transpose(-1, -2)
    cross = sqrtm_psd_3x3(inner)
    return mean_term + torch.diagonal(cov1 + cov2 - 2.0 * cross, dim1=-2,
                                      dim2=-1).sum(-1)


def _device_fields(means, log_scales, quats, device):
    """(mu, cov, sqrtm(cov)) as float32 tensors on ``device`` (the card
    unless given), from numpy arrays or tensors."""
    dev = resolve_device(device)
    f32 = lambda a: (a if torch.is_tensor(a) else torch.from_numpy(
        np.array(a, np.float32))).to(device=dev, dtype=torch.float32)
    cov = make_covariance_3d(f32(log_scales), f32(quats))
    return f32(means), cov, sqrtm_psd_3x3(cov)


def _dist_blocks(fields, rows: np.ndarray, chunk: int):
    """Per block of ``chunk`` query ``rows``, the (block, N) squared W2
    distances to every Gaussian."""
    mu, cov, sqrt = fields
    for i in range(0, len(rows), chunk):
        sel = torch.as_tensor(rows[i:i + chunk], device=mu.device)
        yield wasserstein2_sq(mu[sel][:, None], cov[sel][:, None], mu[None],
                              cov[None], sqrt[None])


def pairwise_w2(means, log_scales, quats, query_idx=None, chunk=256,
                device=None) -> np.ndarray:
    """The (Q, N) squared-W2 distance matrix of the query rows (default
    all) to every Gaussian, computed in chunks of ``chunk`` rows on
    ``device``, as numpy."""
    fields = _device_fields(means, log_scales, quats, device)
    qi = (np.arange(means.shape[0]) if query_idx is None
          else np.asarray(query_idx))
    return np.concatenate([d.cpu().numpy()
                           for d in _dist_blocks(fields, qi, chunk)], 0)


def estimate_eps(means, log_scales, quats, k: int = 4,
                 percentile: float = 90.0, sample: int = 2048,
                 seed: int = 0, device=None) -> float:
    """k-distance eps heuristic: the ``percentile`` of the k-th nearest
    W2 distance over a seeded sample of query rows (the JAX package's
    draw)."""
    n = means.shape[0]
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, size=min(sample, n), replace=False)
    d = pairwise_w2(means, log_scales, quats, query_idx=idx, device=device)
    d_sorted = np.sort(d, axis=1)
    kth = np.sqrt(np.maximum(d_sorted[:, min(k, n - 1)], 0.0))
    return float(np.percentile(kth, percentile))


class DBSCAN:
    """Classic DBSCAN over Gaussian primitives; ``fit`` returns the (N,)
    labels: a cluster id >= 0, or NOISE (-1)."""

    def __init__(self, eps: float, min_pts: int, chunk: int = 512,
                 device=None):
        self.eps = eps
        self.min_pts = min_pts
        self.chunk = chunk
        self.device = device

    def fit(self, means, log_scales, quats) -> np.ndarray:
        fields = _device_fields(means, log_scales, quats, self.device)
        n = means.shape[0]
        eps_sq = self.eps * self.eps

        def within(rows: np.ndarray):
            """Per block of ``rows``, (block, N) bool on the device: which
            Gaussians lie within eps of each row."""
            for d in _dist_blocks(fields, rows, self.chunk):
                yield d <= eps_sq

        # core points in bulk, a chunk of rows at a time
        counts = torch.cat([m.sum(1) for m in within(np.arange(n))])
        core = (counts >= self.min_pts).cpu().numpy()
        labels = np.full(n, UNVISITED, np.int64)
        cluster = 0
        for seed_pt in range(n):
            if labels[seed_pt] != UNVISITED or not core[seed_pt]:
                continue
            labels[seed_pt] = cluster
            frontier = np.array([seed_pt])
            while frontier.size:
                nxt = []
                masks = [m.cpu().numpy() for m in within(frontier)]
                for mask in (row for m in masks for row in m):
                    nb = np.nonzero(mask)[0]
                    fresh = nb[(labels[nb] == UNVISITED)
                               | (labels[nb] == NOISE)]
                    newly_core = fresh[(labels[fresh] == UNVISITED)
                                       & core[fresh]]
                    labels[fresh] = cluster
                    nxt.append(newly_core)
                frontier = (np.unique(np.concatenate(nxt)) if nxt
                            else np.array([], np.int64))
            cluster += 1
        labels[labels == UNVISITED] = NOISE
        return labels

    @staticmethod
    def cluster_stats(labels: np.ndarray) -> dict:
        """The clusters' count, the noise count and each cluster's size."""
        ids, counts = np.unique(labels[labels >= 0], return_counts=True)
        return {
            "num_clusters": int(len(ids)),
            "num_noise": int((labels == NOISE).sum()),
            "sizes": dict(zip(ids.tolist(), counts.tolist())),
        }


def save_clustered_ply(path, means, labels, seed: int = 0):
    """A ply of the means coloured by cluster id (noise grey), the JAX
    package's seeded palette."""
    from ..utils.ply import write_ply

    means = np.asarray(means.cpu() if torch.is_tensor(means) else means)
    rng = np.random.default_rng(seed)
    palette = rng.uniform(50, 255, size=(max(labels.max() + 1, 1), 3))
    cols = np.where(labels[:, None] >= 0,
                    palette[np.maximum(labels, 0)], 30.0)
    write_ply(path, {
        "x": means[:, 0], "y": means[:, 1], "z": means[:, 2],
        "red": cols[:, 0], "green": cols[:, 1], "blue": cols[:, 2],
    })
