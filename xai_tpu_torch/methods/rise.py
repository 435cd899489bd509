"""RISE — randomized masked-forward saliency.

Counterpart of ``xai_tpu/methods/rise.py`` (reference: CLIP/
generate_emap.py:65-104; N=2000, s=8, p1=0.5).  Mask making is split in
two: :func:`draw_grid` draws the Bernoulli grids and the crop offsets from
the image's ``torch.Generator``, and :func:`masks_from_grid` upsamples and
crops them, so a test can feed it the grids and offsets that xai_tpu draws.
"""
from __future__ import annotations

import math

import torch

from ..models.common import target_scores
from ..ops.resize import resize_bilinear
from .gradient import _fit_chunk


def _cell(input_hw: int, s: int) -> int:
    return int(math.ceil(input_hw / s))


def draw_grid(generator: torch.Generator, n_masks: int = 2000, s: int = 8,
              p1: float = 0.5, input_hw: int = 224):
    """(grid ``[N, s, s]`` float32 Bernoulli(p1), offsets ``[N, 2]`` int64
    in [0, cell)), drawn in that order."""
    dev = generator.device
    grid = (torch.rand((n_masks, s, s), device=dev, generator=generator)
            < p1).to(torch.float32)
    offsets = torch.randint(0, _cell(input_hw, s), (n_masks, 2), device=dev,
                            generator=generator)
    return grid, offsets


def masks_from_grid(grid: torch.Tensor, offsets: torch.Tensor,
                    input_hw: int = 224) -> torch.Tensor:
    """[N, H, W] float masks in [0, 1] (generate_emap.py:65-84): each grid
    bilinear-upsampled to (s+1)·cell, then the input-sized crop at its
    offset."""
    n, s = grid.shape[:2]
    up = (s + 1) * _cell(input_hw, s)
    big = resize_bilinear(grid, (up, up))
    span = torch.arange(input_hw, device=grid.device)
    rows = (offsets[:, 0, None] + span)[:, :, None]
    cols = (offsets[:, 1, None] + span)[:, None, :]
    return big[torch.arange(n, device=grid.device)[:, None, None], rows,
               cols]


def generate_masks(generator: torch.Generator, n_masks: int = 2000,
                   s: int = 8, p1: float = 0.5,
                   input_hw: int = 224) -> torch.Tensor:
    return masks_from_grid(*draw_grid(generator, n_masks, s, p1, input_hw),
                           input_hw)


@torch.no_grad()
def _rise_scores(bundle, x: torch.Tensor, masks: torch.Tensor, target: int,
                 chunk: int, raw_scores: bool) -> torch.Tensor:
    """Target score of each masked image x * mask: the softmax
    probability, or the raw output (the reference's CLIP weighting,
    generate_emap.py:95-99).  x ``[C, H, W]``, masks ``[N, H, W]``."""
    out = []
    for lo in range(0, masks.shape[0], chunk):
        xb = (x[None] * masks[lo:lo + chunk, None]).to(bundle.dtype)
        logits = bundle.apply(xb).float()
        out.append(target_scores(
            logits if raw_scores else torch.softmax(logits, dim=-1), target))
    return torch.cat(out)


def rise(bundle, x: torch.Tensor, target: int, generator=None,
         n_masks: int = 2000, s: int = 8, p1: float = 0.5, chunk: int = 50,
         dtype=None, masks=None, raw_scores: bool = False) -> torch.Tensor:
    """Response-weighted mask sum / (N * p1) (generate_emap.py:85-104) of a
    normalized ``[H, W, C]`` input.  Returns [H, W].

    ``dtype=bf16`` runs the N masked forwards on the bundle's bf16 copy;
    the masks, the scores and the weighted sum stay float32.  ``masks``
    (``[N, H, W]``) injects a mask set."""
    hw = x.shape[0]
    if masks is None:
        if generator is None:
            raise ValueError("rise needs a generator or masks")
        masks = generate_masks(generator, n_masks, s, p1, hw)
    masks = torch.as_tensor(masks, dtype=torch.float32, device=x.device)
    n = masks.shape[0]
    scores = _rise_scores(bundle.cast(dtype), x.permute(2, 0, 1), masks,
                          target, _fit_chunk(n, chunk), raw_scores)
    return torch.einsum("n,nhw->hw", scores, masks) / n / p1
