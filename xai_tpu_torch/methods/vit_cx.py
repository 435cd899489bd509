"""ViT-CX, causal explanation via clustered feature-map masks
(util/attribution_methods/ViT_CX/: ViT_CX.py + causal_score.py, vendored
from vaynexie/CausalX-ViT).

Counterpart of ``xai_tpu/methods/vit_cx.py``.  Pipeline: feature maps =
the last block's norm1 output tokens as ``[D, P, P]`` -> bilinear upsample
to the input size (``ops/resize.py``, the weights of ``jax.image.resize``)
-> per-row minmax masks -> pairwise cosine similarity (on the card) ->
complete-linkage agglomerative clustering at distance threshold 0.1 (on
the host: scipy's ``linkage`` and sklearn's ``_hc_cut`` tree cut,
transliterated) -> cluster-sum masks, row-minmaxed -> causal scoring:
``softmax(x*M + noise*(1-M)) - softmax(x + noise*(1-M)) + class_p``,
mask-weighted (causal_score.py:18-59).

The cluster count is padded to a bucket of 64 and the noise is drawn at
that bucket, so the noise slot of a cluster depends on the padding; a
batch pads to its largest image's bucket, and each image's noise is drawn
at its own bucket and zero-padded, so a batched run equals its single
runs.
"""
from __future__ import annotations

from heapq import heappush, heappushpop

import numpy as np
import torch

from ..ops.resize import resize_bilinear

BUCKET = 64


def _bucket(k: int) -> int:
    return ((k + BUCKET - 1) // BUCKET) * BUCKET


@torch.no_grad()
def _masks_and_sim(bundle, xb: torch.Tensor):
    """Stage A of a batch ``[B, C, H, W]``: (row-minmaxed masks ``[B, D,
    H*H]``, cosine similarity ``[B, D, D]``, softmax probs ``[B,
    classes]``), on the model's device."""
    logits, taps = bundle.apply_taps(xb)
    probs = torch.softmax(logits.float(), -1)
    feat = taps["norm1_out"][-1][:, 1:]                 # [B, P*P, D]
    b, n, d = feat.shape
    side = int(n ** 0.5)
    h = xb.shape[-1]
    fmap = feat.reshape(b, side, side, d).permute(0, 3, 1, 2)
    m = resize_bilinear(fmap, (h, h)).reshape(b, d, h * h)
    mn = m.amin(2, keepdim=True)
    mx = m.amax(2, keepdim=True)
    masks = (m - mn) / (mx - mn)
    norms = torch.linalg.vector_norm(masks, dim=2)
    sim = (masks @ masks.transpose(1, 2)) / torch.clamp(
        norms[:, :, None] * norms[:, None, :], min=1e-12)
    return masks, sim, probs


def _hc_cut(n_clusters: int, children: np.ndarray,
            n_leaves: int) -> np.ndarray:
    """Exact transliteration of sklearn's ``_hc_cut`` tree cut (heap of
    negated node ids, enumerated in FINAL HEAP ORDER: the numbering is
    part of the contract, since a cluster's index selects its noise slot
    downstream)."""
    nodes = [-(max(children[-1]) + 1)]
    for _ in range(n_clusters - 1):
        these = children[-nodes[0] - n_leaves]
        heappush(nodes, -these[0])
        heappushpop(nodes, -these[1])
    label = np.zeros(n_leaves, dtype=np.intp)
    for i, node in enumerate(nodes):
        stack = [-node]
        desc = []
        while stack:
            nd = stack.pop()
            if nd < n_leaves:
                desc.append(nd)
            else:
                stack.extend(children[nd - n_leaves])
        label[desc] = i
    return label


def cluster_host(sim: np.ndarray, distance_threshold: float) -> np.ndarray:
    """Complete-linkage agglomerative clustering of a ``[D, D]`` cosine
    similarity at a distance threshold, label for label sklearn's
    (ViT_CX.py:92-107), which hands the merge tree to scipy's ``linkage``
    and labels it with ``_hc_cut``.  Only the upper triangle is read (the
    card's product need not be exactly symmetric)."""
    from scipy.cluster import hierarchy
    from scipy.spatial.distance import squareform

    dist = 1.0 - np.nan_to_num(sim)
    np.fill_diagonal(dist, 0.0)
    out = hierarchy.linkage(squareform(dist, checks=False),
                            method="complete")
    children = out[:, :2].astype(np.intp)
    n_clusters = int(np.count_nonzero(out[:, 2] >= distance_threshold) + 1)
    return _hc_cut(n_clusters, children, sim.shape[0])


def _chunk_for(kp: int, gpu_batch: int) -> int:
    """Largest divisor of Kp that is <= gpu_batch (xai_tpu's chunking of
    the scoring sweep)."""
    for c in range(min(gpu_batch, kp), 0, -1):
        if kp % c == 0:
            return c
    return 1


@torch.no_grad()
def _cluster_and_score(model, x, masks, labels, kp: int, noise, class_p,
                       target: int, real_k: int, chunk: int):
    """Stage B of one image: cluster-sum masks (padded to ``kp``),
    row-minmax, the causal scoring sweep, the final minmax.  x: ``[H, W,
    C]``; masks: ``[D, H*H]``; labels: ``[D]``; noise: ``[kp, H, W, 3]``,
    all on the model's device and in its dtype but the labels."""
    h = x.shape[0]
    oh = torch.nn.functional.one_hot(labels, kp).float()     # [D, kp]
    cm = (oh.T @ masks.float()).to(masks.dtype)
    mn = cm.amin(1, keepdim=True)
    mx = cm.amax(1, keepdim=True)
    live = mx > mn
    cm = torch.where(live, (cm - mn) / torch.where(live, mx - mn, 1.0), 0.0)
    cm = cm.view(kp, h, h)

    def probs(xs):
        return torch.softmax(model.apply(xs.permute(0, 3, 1, 2)
                                         .contiguous()).float(), -1)

    diffs = []
    for i in range(0, kp, chunk):
        mb, nb = cm[i:i + chunk, ..., None], noise[i:i + chunk]
        noisy = nb * (1.0 - mb)
        pm = probs(x[None] * mb + noisy)[:, target]
        po = probs(x[None] + noisy)[:, target]
        diffs.append(pm - po + class_p)
    diffs = torch.cat(diffs)
    mask_div = cm / cm.sum(0, keepdim=True)
    sal = torch.einsum("k,khw->hw", diffs, mask_div.float()) / real_k
    return (sal - sal.min()) / (sal.max() - sal.min())


def _draw_noise(generator, k: int, h: int, device) -> torch.Tensor:
    """One image's noise, drawn at its own bucket: ``[bucket(k), H, W,
    3]`` normal * 0.1."""
    return torch.randn((_bucket(k), h, h, 3), generator=generator,
                       device=device) * 0.1


def vit_cx_batch(bundle, xs, targets=None, distance_threshold: float = 0.1,
                 gpu_batch: int = 64, generators=None, noise=None,
                 dtype=None) -> np.ndarray:
    """ViT-CX of ``[B, H, W, C]`` images -> ``[B, H, W]`` minmax maps.

    Stage A (the forward with taps, the masks and their similarity) is one
    batched call; the clustering is on the host, image by image; stage B
    pads every image to the batch's largest cluster bucket Kp.
    ``generators``: one ``torch.Generator`` per image, each drawing its
    image's noise at the image's own bucket (default: one generator of
    seed 0 drawing them in turn); ``noise``: per-image pre-drawn ``[K_i,
    H, W, 3]`` noise (already scaled by 0.1), the parity hook.  ``dtype``
    runs the scoring forwards, masks and noise on the bundle's cast copy;
    the softmaxes and the weighted sum stay float32."""
    xs = torch.as_tensor(xs, dtype=torch.float32, device=bundle.device)
    b, h = xs.shape[0], xs.shape[1]
    masks, sim, probs = _masks_and_sim(bundle, xs.permute(0, 3, 1, 2)
                                       .contiguous())
    sims = sim.cpu().numpy()
    labels = [cluster_host(s, distance_threshold) for s in sims]
    ks = [int(lab.max()) + 1 for lab in labels]
    kp = max(_bucket(k) for k in ks)
    if targets is None:
        targets = probs.argmax(-1).tolist()
    targets = [int(t) for t in targets]
    if noise is None and generators is None:
        gen = torch.Generator(bundle.device).manual_seed(0)
        generators = [gen] * b
    model = bundle.cast(dtype)
    chunk = _chunk_for(kp, gpu_batch)
    out = []
    for i in range(b):
        if noise is not None:
            nz = torch.as_tensor(noise[i], dtype=torch.float32,
                                 device=bundle.device)
            assert nz.shape == (ks[i], h, h, 3), (nz.shape, ks[i])
        else:
            nz = _draw_noise(generators[i], ks[i], h, bundle.device)
        nz = torch.cat([nz, nz.new_zeros((kp - nz.shape[0], h, h, 3))])
        lab = torch.as_tensor(labels[i], dtype=torch.int64,
                              device=bundle.device)
        out.append(_cluster_and_score(
            model, xs[i].to(model.dtype), masks[i].to(model.dtype), lab,
            kp, nz.to(model.dtype), probs[i, targets[i]], targets[i],
            ks[i], chunk))
    return torch.stack(out).cpu().numpy()


def vit_cx(bundle, x, target=None, distance_threshold: float = 0.1,
           gpu_batch: int = 50, generator=None, noise=None,
           dtype=None) -> np.ndarray:
    """The minmax-normalized ``[H, W]`` map of one ``[H, W, C]`` image
    (evaluatePerturbation.py:231-235): the batch of one of
    :func:`vit_cx_batch` at xai_tpu's single-image chunking.  ``noise``:
    optional pre-drawn ``[K, H, W, 3]`` noise (scaled by 0.1)."""
    x = torch.as_tensor(x)
    if x.dim() == 4:
        x = x[0]
    return vit_cx_batch(
        bundle, x[None], None if target is None else [target],
        distance_threshold, gpu_batch,
        None if generator is None else [generator],
        None if noise is None else [noise], dtype)[0]
