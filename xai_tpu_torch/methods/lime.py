"""LIME image explanation on the device.

Counterpart of ``xai_tpu/methods/lime.py`` (the vendored LIME:
limeAttr.py + lime_image.py + lime_base.py).  Driver configuration
(limeAttr.py:23-36): quickshift segments (kernel_size 4, max_dist 200,
ratio 0.2) -> 1000 random binary segment masks, the first all-on ->
images with the off segments set to ``hide_color`` -> softmax
probabilities -> cosine-distance exponential kernel weights (width 0.25)
-> weighted ridge (alpha 1, intercept) for the top label -> binary mask of
the top positive-weight segments.

Every step runs on the image's device, in stages that
``chip_smoke.py`` times one by one: :func:`segment` (the quickshift
kernel and the label compaction), :func:`sample_rows`, :func:`sweep`
(the per-pixel on/off plane is the exact gather ``rows[:, labels]``) and
:func:`ridge_select`.  The masks come back as float32 ``[B, H, W]``.

The sample rows come from a ``torch.Generator`` per image, so they differ
from ``xai_tpu``'s threefry draws by construction; ``rows=`` injects the
same rows into both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.quickshift import (_parents_batch, parents_to_labels_batch,
                              quickshift_params)

# segment-count bucket: quickshift(kernel_size=4, max_dist=200) yields
# ~50-250 segments on 224 px natural images; segments past it merge into
# the last entry
_F_MAX = 512

# driver quickshift config (limeAttr.py:23-36)
_QS_RATIO = 0.2
_QS_KERNEL = 4.0
_QS_MAXDIST = 200.0


def _as_images(imgs, device) -> torch.Tensor:
    """Numpy or tensor images -> float32 tensor on the device: a tensor's
    own, else ``device`` (CUDA unless ``device="cpu"``)."""
    if isinstance(imgs, torch.Tensor):
        return imgs.to(torch.float32)
    from ..runners.common import resolve_device
    return torch.as_tensor(np.asarray(imgs, np.float32),
                           device=resolve_device(device))


def segment(imgs: torch.Tensor):
    """[B, H, W, 3] in [0, 1] -> (labels [B, H*W] int64 clamped to
    ``_F_MAX - 1``, segment counts [B] unclamped)."""
    w, wd, inv2s2, max_d2 = quickshift_params(_QS_KERNEL, _QS_MAXDIST)
    parents = _parents_batch(imgs, w, wd, _QS_RATIO, inv2s2, max_d2)
    labels, counts = parents_to_labels_batch(parents)
    return labels.long().clamp(max=_F_MAX - 1), counts


def sample_rows(generators, counts: torch.Tensor, num_samples: int):
    """[B, S, F] int8 binary rows, one generator per image: columns past
    the image's segment count are 0 and row 0 is all-on
    (lime_image.py:175)."""
    rows = []
    for g, cnt in zip(generators, counts):
        colok = (torch.arange(_F_MAX, device=counts.device) < cnt).to(
            torch.int8)
        r = torch.randint(0, 2, (num_samples, _F_MAX), generator=g,
                          dtype=torch.int8, device=counts.device) * colok
        r[0] = colok
        rows.append(r)
    return torch.stack(rows)


@torch.inference_mode()
def sweep(bundle, imgs: torch.Tensor, labels: torch.Tensor,
          rows: torch.Tensor, chunk: int, hide_color: float = 0.0,
          normalize_fn=None) -> torch.Tensor:
    """Softmax probabilities [B, S, classes] of every sample image.  Each
    chunk of ``chunk`` rows (zero-padded to a multiple) builds its images
    ``where(rows_c[:, labels], img, hide_color)`` and runs one batched
    forward in the bundle's dtype; the softmax is taken in float32.
    ``normalize_fn`` maps channel-last images."""
    b, h, wi = imgs.shape[:3]
    s = rows.shape[1]
    pad = (-s) % chunk
    rows_p = torch.cat([rows, rows.new_zeros((b, pad, rows.shape[2]))], 1)
    img_c = imgs.permute(0, 3, 1, 2)[:, None]                 # [B,1,3,H,W]
    probs = []
    for start in range(0, s + pad, chunk):
        rows_c = rows_p[:, start:start + chunk]               # [B, c, F]
        on = torch.gather(rows_c, 2, labels[:, None].expand(
            -1, rows_c.shape[1], -1)).view(b, -1, 1, h, wi)
        xb = torch.where(on > 0, img_c, hide_color)           # [B,c,3,H,W]
        if normalize_fn is not None:
            xb = normalize_fn(xb.permute(0, 1, 3, 4, 2)).permute(
                0, 1, 4, 2, 3)
        logits = bundle.apply(xb.reshape((-1,) + xb.shape[2:]).to(
            bundle.dtype))
        probs.append(torch.softmax(logits.float(), dim=-1).view(
            b, rows_c.shape[1], -1))
    return torch.cat(probs, 1)[:, :s]


def ridge_select(rows: torch.Tensor, probs: torch.Tensor,
                 labels: torch.Tensor, counts: torch.Tensor,
                 num_features: int, kernel_width: float, alpha: float = 1.0):
    """The weighted ridge of the top label's probabilities on the rows,
    then the mask of the top-|coef| positive segments.  Returns (masks
    [B, H*W] float32, coef [B, F])."""
    b, _, f = rows.shape
    cls = torch.argmax(probs[:, 0], dim=-1)                   # [B]
    y = torch.gather(probs, 2, cls.view(b, 1, 1).expand(
        -1, probs.shape[1], 1))[..., 0]                       # [B, S]

    # weighted ridge (alpha, intercept) by the normal equations; padded
    # columns are all-zero, so the diagonal alpha forces their coef to 0.
    # wgt = sqrt(kernel), then sw = sqrt(wgt): lime_base's semantics.
    x = rows.float()
    colok = (torch.arange(f, device=rows.device) < counts[:, None]).float()
    nrm = torch.linalg.vector_norm(x, dim=2)
    cos = (x @ colok[..., None])[..., 0] / torch.clamp(
        nrm * counts.float().sqrt()[:, None], min=1e-12)
    wgt = torch.sqrt(torch.exp(-((1.0 - cos) ** 2) / kernel_width ** 2))
    wsum = wgt.sum(1, keepdim=True)
    xm = (x * wgt[..., None]).sum(1) / wsum                   # [B, F]
    ym = (y * wgt).sum(1, keepdim=True) / wsum                # [B, 1]
    sw = torch.sqrt(wgt)
    xc = (x - xm[:, None]) * sw[..., None]
    yc = (y - ym) * sw
    a = xc.transpose(1, 2) @ xc + alpha * torch.eye(f, device=rows.device)
    coef = torch.cholesky_solve(xc.transpose(1, 2) @ yc[..., None],
                                torch.linalg.cholesky(a))[..., 0]

    # top-|coef| positive segments until num_features (the lime tail);
    # stable, as jnp.argsort is
    order = torch.argsort(-coef.abs(), dim=1, stable=True)
    pos = torch.gather(coef, 1, order) > 0
    keep = pos & (torch.cumsum(pos.int(), dim=1) <= num_features)
    chosen = torch.zeros_like(coef).scatter_(1, order, keep.float())
    return torch.gather(chosen, 1, labels), coef


def lime_segments(img, device=None) -> tuple:
    """The pipeline's quickshift labels of one image: ([H, W] int labels,
    segment count), with the same ``_F_MAX`` clamp."""
    imgs = _as_images(img, device)[None]
    labels, counts = segment(imgs)
    h, wi = imgs.shape[1:3]
    return (labels[0].view(h, wi).cpu().numpy(),
            min(int(counts[0]), _F_MAX))


def lime_batch(bundle, imgs, generators, num_samples: int = 1000,
               num_features: int = 5, kernel_width: float = 0.25,
               hide_color: float = 0.0, chunk: int = 64,
               normalize_input=None, dtype=None, rows=None,
               return_coef: bool = False, device=None):
    """Cross-image batched LIME on the device.  imgs: [B, H, W, 3] in
    [0, 1], numpy (moved to ``device``, CUDA by default) or a tensor;
    generators: one ``torch.Generator`` per image on that device.
    ``rows`` ([B, S, F<=512] binary) injects the sample rows, used as
    given.  ``dtype=torch.bfloat16`` runs the sweep's forwards on the
    bundle's bf16 copy; segmentation, ridge and mask stay float32.
    Returns [B, H, W] float32 binary masks; with ``return_coef`` a
    (masks, [B, F] signed ridge coefficient) tuple, both numpy."""
    imgs = _as_images(imgs, device)
    b, h, wi = imgs.shape[:3]
    labels, counts = segment(imgs)
    if rows is None:
        rows_t = sample_rows(generators, counts, int(num_samples))
    else:
        rows = np.asarray(rows, np.int8)
        rows_t = torch.zeros(rows.shape[:2] + (_F_MAX,), dtype=torch.int8,
                             device=imgs.device)
        rows_t[..., :rows.shape[-1]] = torch.from_numpy(rows)
    probs = sweep(bundle.cast(dtype), imgs, labels, rows_t, int(chunk),
                  float(hide_color), normalize_input)
    masks, coef = ridge_select(rows_t, probs, labels, counts,
                               int(num_features), float(kernel_width))
    masks = masks.view(b, h, wi).cpu().numpy()
    return (masks, coef.cpu().numpy()) if return_coef else masks


def lime(bundle, img, generator, num_samples: int = 1000,
         num_features: int = 5, kernel_width: float = 0.25,
         hide_color: float = 0.0, chunk: int = 100, normalize_input=None,
         dtype=None, rows=None, device=None) -> np.ndarray:
    """img: [H, W, 3] in [0, 1] (the driver feeds the *unnormalized*
    trans_img, as the reference does).  Returns the [H, W] binary mask of
    the top positive segments.  Delegates to :func:`lime_batch` with
    B=1, so single and batched attributions agree."""
    if not isinstance(img, torch.Tensor):
        img = np.asarray(img)
    return lime_batch(bundle, img[None], [generator],
                      num_samples=num_samples, num_features=num_features,
                      kernel_width=kernel_width, hide_color=hide_color,
                      chunk=chunk, normalize_input=normalize_input,
                      dtype=dtype,
                      rows=None if rows is None else np.asarray(rows)[None],
                      device=device)[0]


def _weighted_ridge(X, y, w, alpha=1.0):
    """sklearn Ridge(alpha, fit_intercept=True) with sample weights, the
    host mirror of the device solve (``xai_tpu``'s sklearn-parity
    surface)."""
    sw = np.sqrt(w)
    # center by weighted means (intercept handling)
    xm = (X * w[:, None]).sum(0) / w.sum()
    ym = (y * w).sum() / w.sum()
    Xc = (X - xm) * sw[:, None]
    yc = (y - ym) * sw
    A = Xc.T @ Xc + alpha * np.eye(X.shape[1])
    coef = np.linalg.solve(A, Xc.T @ yc)
    intercept = ym - xm @ coef
    return coef, intercept
