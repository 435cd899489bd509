"""TIS, Transformer Input Sampling (util/attribution_methods/TIS.py,
vendored from aenglebert/Transformer_Input_Sampling).

Counterpart of ``xai_tpu/methods/tis.py``.  Pipeline (TIS.py:59-365):
concat all block outputs along features -> ``[n_activations, n_tokens]``
-> k-means (n_masks clusters) on the activation rows -> each centroid's
top-50 % tokens as a binary mask -> score each mask by a forward that
keeps only CLS and the mask's tokens (token dropping after the positional
embedding) -> saliency = score-weighted mask sum / coverage, minmax.

k-means is Lloyd's algorithm on the model's device in float32; every
mask keeps the same token count, so each chunk of masks is one forward
with per-row ``token_indices``.
"""
from __future__ import annotations

from typing import Optional

import torch


@torch.no_grad()
def kmeans(points: torch.Tensor, generator: torch.Generator,
           n_clusters: int, iters: int = 50,
           init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Lloyd's algorithm, euclidean, random-point init: the functional
    equivalent of fast_pytorch_kmeans (TIS.py:151-155).  points:
    ``[P, D]`` float32 -> centroids ``[n_clusters, D]``.  The initial
    points are drawn without replacement from ``generator``, or given as
    ``init`` (their ``[n_clusters]`` row indices).

    The assignment takes the argmin of ``||c||^2 - 2 p.c``: both terms are
    ~``||p||^2`` while their difference is small, so the product must be
    true float32 (xai_tpu pins ``Precision.HIGHEST``; here TF32 is off,
    ``runners/common.py resolve_device``) or near-tie assignments flip."""
    p = points.shape[0]
    if init is None:
        if n_clusters > p:
            # as jax.random.choice(replace=False) refuses it in xai_tpu
            raise ValueError(f"cannot draw {n_clusters} initial centroids "
                             f"without replacement from {p} points")
        init = torch.randperm(p, generator=generator,
                              device=generator.device)[:n_clusters]
    c = points[torch.as_tensor(init, device=points.device)]
    for _ in range(iters):
        d = (c * c).sum(-1)[None, :] - 2.0 * (points @ c.T)     # [P, K]
        one = torch.nn.functional.one_hot(d.argmin(1), c.shape[0]) \
            .to(points.dtype)
        counts = one.sum(0)
        sums = one.T @ points
        c = torch.where(counts[:, None] > 0,
                        sums / counts.clamp(min=1)[:, None], c)
    return c


@torch.no_grad()
def tis(bundle, x: torch.Tensor, target: Optional[int] = None,
        n_masks: int = 1024, tokens_ratio: float = 0.5,
        batch_size: int = 64, generator: Optional[torch.Generator] = None,
        normalise: bool = True, centroids=None, dtype=None) -> torch.Tensor:
    """The ``[P, P]`` token saliency map of one ``[H, W, C]`` image
    (TIS.__call__).

    ``centroids`` (``[n_masks, n_tokens]``) bypasses k-means: the
    shared-centroid oracle of xai_tpu's tests (k-means outputs are not
    comparable across libraries; everything after them is).
    ``generator`` draws k-means' initial points (default: seed 0 on the
    model's device, as xai_tpu's default key).  ``dtype`` runs the
    ``n_masks`` token-dropped scoring forwards on the bundle's cast copy;
    the tap forward, k-means, the masks and the weighted sum stay
    float32."""
    if x.dim() == 3:
        x = x[None]
    xb = x.permute(0, 3, 1, 2).contiguous()
    logits, taps = bundle.apply_taps(xb)
    if target is None:
        target = int(logits[0].argmax())

    # encoder activations: concat block outputs on features, drop CLS,
    # transpose -> [L*D, n_tokens] (TIS.py:129-148)
    blocks = taps["block_out"]                          # [L, B, N, D]
    acts = torch.cat(list(blocks[:, 0]), dim=-1)[1:].T.contiguous()
    n_tokens = acts.shape[1]
    if centroids is None:
        if generator is None:
            generator = torch.Generator(xb.device).manual_seed(0)
        centroids = kmeans(acts, generator, n_masks)
    else:
        centroids = torch.as_tensor(centroids, dtype=torch.float32,
                                    device=xb.device)

    k = int(tokens_ratio * n_tokens)
    top = torch.topk(centroids, k, dim=1).indices       # [n_masks, k]
    masks = torch.zeros((n_masks, n_tokens), device=xb.device).scatter_(
        1, top, 1.0)

    chunk = batch_size
    while n_masks % chunk:
        chunk -= 1
    model = bundle.cast(dtype)
    xs = xb.to(model.dtype).expand(chunk, -1, -1, -1)
    scores = torch.cat([
        torch.softmax(model.apply_tokens(xs, top[i:i + chunk]), -1)
        [:, target] for i in range(0, n_masks, chunk)]).float()

    raw = scores @ masks
    # a token in no centroid's top-k has raw == 0 AND coverage == 0; the
    # reference's raw / coverage (TIS.py:358) makes that a NaN that
    # poisons the whole map through the max-normalize.  xai_tpu clamps the
    # coverage at 1, so the dead token scores 0 (covered tokens have
    # integer coverage >= 1 and are unchanged)
    sal = raw / masks.sum(0).clamp(min=1.0)
    side = int(n_tokens ** 0.5)
    sal = sal.view(side, side)
    if normalise:
        sal = sal - sal.min()
        sal = sal / sal.max()
    return sal
