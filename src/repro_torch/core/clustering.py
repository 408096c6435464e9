"""Offline clustering of similar attention heads (port of
``repro/core/clustering.py``; paper §5.2, Appendix A.4 and C).

  1. block attention maps of every (layer, head) from a profiling prefill
     (:func:`repro_torch.core.profile.capture_block_attention_maps`);
  2. each map pooled to ``POOLED × POOLED`` and scaled to its maximum, then
     embedded by a small convolutional autoencoder (latent 64) trained with
     a hand-written Adam loop and early stopping;
  3. latents L2-normalised and clustered by average-linkage agglomerative
     clustering under a distance threshold (numpy Lance–Williams, as the
     reference: no scipy);
  4. clusters smaller than ``min_cluster_size`` become noise (−1).

The result is the static head dictionary: ``(L, H)`` int32 cluster ids,
which :meth:`repro_torch.core.api.SharePrefill.from_clustering` takes.  Its
artifact is the reference's JSON ``{"cluster_ids": (L, H) list,
"num_clusters": int}``.

The autoencoder's parameters are a plain dict, as the models' are, in
PyTorch's layouts: ``conv1`` ``(16, 1, 3, 3)`` and ``conv2`` ``(32, 16, 3,
3)`` (OIHW), ``enc_w`` ``(32·P/4·P/4, 64)`` whose rows follow the NCHW
flatten order ``(c, h, w)``, ``enc_b``, ``dec_w`` ``(64, P·P)``, ``dec_b``.
:func:`autoencoder_from_numpy` carries the reference's (HWIO kernels, rows
in the NHWC order ``(h, w, c)``) across.  Training runs on the maps'
device in float32, with TF32 off.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

POOLED = 32          # pooled attention-map side fed to the autoencoder
LATENT = 64          # paper Appendix A.4: latent dimension 64

AEParams = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------
# Attention-map preprocessing
# --------------------------------------------------------------------------

def pool_map(score_map: torch.Tensor, out: int = POOLED) -> torch.Tensor:
    """Average-pool ``(…, NB, NB)`` block score maps to ``(…, out, out)``;
    a map smaller than ``out`` is first repeated up to at least ``out``,
    and the side is cropped to ``(nb // out) * out``."""
    nb = score_map.shape[-1]
    if nb < out:
        reps = -(-out // nb)
        score_map = score_map.repeat_interleave(reps, -2).repeat_interleave(
            reps, -1)
        nb = score_map.shape[-1]
    crop = (nb // out) * out
    x = score_map[..., :crop, :crop]
    x = x.reshape(*x.shape[:-2], out, crop // out, out, crop // out)
    return x.mean(dim=(-3, -1))


def binarize_maps(maps: torch.Tensor, gamma: float = 0.9) -> torch.Tensor:
    """Scale each pooled map by its maximum into [0, 1] (patterns, not
    magnitudes, cluster)."""
    flat = maps.reshape(maps.shape[0], -1)
    mx = flat.amax(dim=-1, keepdim=True)
    return (flat / torch.clamp(mx, min=1e-12)).reshape(maps.shape)


# --------------------------------------------------------------------------
# Convolutional autoencoder (paper Appendix C, at POOLED × POOLED input)
# --------------------------------------------------------------------------

def init_autoencoder(generator: torch.Generator, pooled: int = POOLED, *,
                     device=None) -> AEParams:
    """Random parameters from the reference's distributions (kernels
    normal × 0.1, dense matrices normal / √(fan_in + 1), zero biases), drawn
    from ``generator`` (which must live on ``device``).  Same distributions,
    not the same numbers."""
    p4 = pooled // 4
    flat = 32 * p4 * p4
    normal = lambda *shape: torch.randn(shape, generator=generator,
                                        device=device)
    return dict(
        conv1=normal(16, 1, 3, 3) * 0.1,
        conv2=normal(32, 16, 3, 3) * 0.1,
        enc_w=normal(flat, LATENT) / np.sqrt(flat + 1.0),
        enc_b=torch.zeros(LATENT, device=device),
        dec_w=normal(LATENT, pooled * pooled) / np.sqrt(LATENT + 1.0),
        dec_b=torch.zeros(pooled * pooled, device=device),
    )


def autoencoder_from_numpy(flat: Dict[str, np.ndarray], *,
                           device=None) -> AEParams:
    """The reference's autoencoder parameters (numpy) in the port's layouts:
    HWIO kernels to OIHW, and ``enc_w``'s rows from the NHWC flatten order
    ``(h, w, c)`` to the NCHW order ``(c, h, w)``."""
    conv = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    enc_w = np.asarray(flat["enc_w"], np.float32)
    c = np.asarray(flat["conv2"]).shape[-1]
    side = int(round((enc_w.shape[0] // c) ** 0.5))
    enc_w = enc_w.reshape(side, side, c, -1).transpose(2, 0, 1, 3)
    return dict(
        conv1=conv(np.asarray(flat["conv1"]).transpose(3, 2, 0, 1)),
        conv2=conv(np.asarray(flat["conv2"]).transpose(3, 2, 0, 1)),
        enc_w=conv(enc_w.reshape(-1, enc_w.shape[-1])),
        enc_b=conv(flat["enc_b"]), dec_w=conv(flat["dec_w"]),
        dec_b=conv(flat["dec_b"]))


def encode(params: AEParams, maps: torch.Tensor) -> torch.Tensor:
    """``(M, P, P)`` pooled maps → ``(M, LATENT)`` embeddings (3 × 3
    convolutions with SAME padding, 2 × 2 max-pooling with VALID)."""
    x = maps[:, None]                                   # NCHW
    x = F.max_pool2d(F.relu(F.conv2d(x, params["conv1"], padding=1)), 2)
    x = F.max_pool2d(F.relu(F.conv2d(x, params["conv2"], padding=1)), 2)
    return x.reshape(x.shape[0], -1) @ params["enc_w"] + params["enc_b"]


def decode(params: AEParams, z: torch.Tensor,
           pooled: int = POOLED) -> torch.Tensor:
    x = torch.sigmoid(z @ params["dec_w"] + params["dec_b"])
    return x.reshape(-1, pooled, pooled)


@contextlib.contextmanager
def _no_tf32():
    """Float32 products and convolutions without TF32 (restored after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _train(maps: torch.Tensor, *, epochs: int, lr: float, seed: int,
           patience: int, params: Optional[AEParams]):
    """:func:`train_autoencoder`'s loop; also returns the epochs run and the
    last epoch's loss."""
    pooled = maps.shape[-1]
    if params is None:
        gen = torch.Generator(device=maps.device).manual_seed(seed)
        params = init_autoencoder(gen, pooled, device=maps.device)
    p = {k: v.detach().to(maps.device, torch.float32).clone()
         .requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    best, since_best = np.inf, 0
    b1, b2, eps = 0.9, 0.999, 1e-8
    t, lv = 0, float("nan")
    with _no_tf32():
        for t in range(1, epochs + 1):
            loss = ((decode(p, encode(p, maps), pooled) - maps) ** 2).mean()
            grads = torch.autograd.grad(loss, list(p.values()))
            with torch.no_grad():
                for (k, w), g in zip(p.items(), grads):
                    m[k] = b1 * m[k] + (1 - b1) * g
                    v2[k] = b2 * v2[k] + (1 - b2) * g ** 2
                    mh = m[k] / (1 - b1 ** t)
                    vh = v2[k] / (1 - b2 ** t)
                    w -= lr * mh / (torch.sqrt(vh) + eps)
            lv = float(loss.detach())
            if lv < best - 1e-6:
                best, since_best = lv, 0
            else:
                since_best += 1
                if since_best >= patience:
                    break
    return {k: w.detach() for k, w in p.items()}, t, lv


def train_autoencoder(maps: torch.Tensor, *, epochs: int = 300,
                      lr: float = 1e-3, seed: int = 0, patience: int = 30,
                      params: Optional[AEParams] = None) -> AEParams:
    """MSE reconstruction training with Adam and early stopping (paper
    A.4): full-batch steps, ``b1 = 0.9``, ``b2 = 0.999``, ``eps = 1e-8``
    added to √v̂, stop once the loss has not fallen below the best by 1e-6
    for ``patience`` epochs.  ``params`` is the initial parameter set (the
    reference's carried across by :func:`autoencoder_from_numpy`); without
    it one is drawn from a generator seeded with ``seed``."""
    return _train(maps, epochs=epochs, lr=lr, seed=seed, patience=patience,
                  params=params)[0]


# --------------------------------------------------------------------------
# Average-linkage agglomerative clustering (numpy; scipy unavailable)
# --------------------------------------------------------------------------

def pairwise_distances(z: np.ndarray) -> np.ndarray:
    """Euclidean distances between the rows of ``z``, as the reference
    computes them."""
    return np.sqrt(np.maximum(
        ((z[:, None, :] - z[None, :, :]) ** 2).sum(-1), 0.0))


def agglomerative_cluster(x: np.ndarray, distance_threshold: float
                          ) -> np.ndarray:
    """Average-linkage clustering; merge while min inter-cluster dist < thr.

    Lance-Williams update for average linkage:
        d(k, i∪j) = (n_i d(k,i) + n_j d(k,j)) / (n_i + n_j)
    Returns integer labels (0..K-1).
    """
    n = x.shape[0]
    d = pairwise_distances(x)
    np.fill_diagonal(d, np.inf)
    sizes = np.ones(n)
    alive = np.ones(n, dtype=bool)
    members: list[list[int]] = [[i] for i in range(n)]

    while alive.sum() > 1:
        sub = np.where(alive)[0]
        dd = d[np.ix_(sub, sub)]
        flat = np.argmin(dd)
        a, b = divmod(flat, dd.shape[1])
        i, j = sub[a], sub[b]
        if d[i, j] >= distance_threshold:
            break
        # merge j into i
        ni, nj = sizes[i], sizes[j]
        newrow = (ni * d[i] + nj * d[j]) / (ni + nj)
        d[i, :] = newrow
        d[:, i] = newrow
        d[i, i] = np.inf
        d[j, :] = np.inf
        d[:, j] = np.inf
        sizes[i] = ni + nj
        alive[j] = False
        members[i].extend(members[j])
        members[j] = []

    labels = np.full(n, -1, dtype=np.int32)
    k = 0
    for i in range(n):
        if alive[i]:
            for idx in members[i]:
                labels[idx] = k
            k += 1
    return labels


# --------------------------------------------------------------------------
# End-to-end head clustering
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ClusteringResult:
    cluster_ids: np.ndarray      # (L, H) int32, -1 = noise
    num_clusters: int
    latents: np.ndarray          # (L*H, LATENT) for diagnostics
    # diagnostics of the run: the autoencoder's epochs and last loss, the
    # distance threshold used, and the wall seconds of each stage
    epochs: int = 0
    final_loss: float = float("nan")
    distance_threshold: float = float("nan")
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    def cluster_ids_for_layer(self, layer: int) -> np.ndarray:
        return self.cluster_ids[layer]


def cluster_heads(score_maps, *, distance_threshold: float | None = None,
                  min_cluster_size: int = 5, ae_epochs: int = 300,
                  seed: int = 0, params: Optional[AEParams] = None
                  ) -> ClusteringResult:
    """score_maps: ``(L, H, NB, NB)`` block attention maps from a profiling
    run (numpy, or a tensor on the device to train on).

    ``distance_threshold=None`` takes the 25th percentile of the
    off-diagonal distances between the L2-normalised latents.  ``params``
    is the autoencoder's initial parameter set (see
    :func:`train_autoencoder`)."""
    maps = torch.as_tensor(score_maps).float()
    l, h = maps.shape[:2]
    t0 = time.perf_counter()
    pooled = binarize_maps(pool_map(maps.reshape(l * h, *maps.shape[2:])))
    params, epochs, loss = _train(pooled, epochs=ae_epochs, lr=1e-3,
                                  seed=seed, patience=30, params=params)
    with _no_tf32(), torch.no_grad():
        z = encode(params, pooled).cpu().numpy()
    t1 = time.perf_counter()
    z = z / np.maximum(np.linalg.norm(z, axis=-1, keepdims=True), 1e-12)
    if distance_threshold is None:
        off = pairwise_distances(z)[~np.eye(len(z), dtype=bool)]
        distance_threshold = float(np.percentile(off, 25.0))
    labels = agglomerative_cluster(z, distance_threshold)

    # small clusters → noise (paper A.4: clusters with < 5 samples)
    out = labels.copy()
    k = 0
    for lbl in np.unique(labels):
        idx = labels == lbl
        if idx.sum() < min_cluster_size:
            out[idx] = -1
        else:
            out[idx] = k
            k += 1
    return ClusteringResult(
        cluster_ids=out.reshape(l, h).astype(np.int32),
        num_clusters=max(k, 1),
        latents=z, epochs=epochs, final_loss=loss,
        distance_threshold=distance_threshold,
        seconds={"autoencoder": t1 - t0,
                 "agglomerative": time.perf_counter() - t1})


def jaccard_similarity_matrix(masks: np.ndarray) -> np.ndarray:
    """Paper Figure 2(b): Jaccard (# intersection / # union) between head
    patterns.  masks: (M, NB, NB) bool."""
    m = masks.reshape(masks.shape[0], -1).astype(np.float64)
    inter = m @ m.T
    sums = m.sum(axis=1)
    union = sums[:, None] + sums[None, :] - inter
    return inter / np.maximum(union, 1.0)
