"""Gradient-path attributions: grad, input×grad, IG, LIG, IDG, IDGI,
SmoothGrad.

Counterpart of ``xai_tpu/methods/gradient.py`` (reference:
util/attribution_methods/saliencyMethods.py).  Every IG-family method is
one chunked forward + backward sweep over a flat stack of interpolation
images (:func:`_flat_grads`, with one target per row); the batched methods
of ``methods/batch.py`` fold their image axis into the same sweep.  The
LIG cutoff is an argmax over the logit trace; IDG's alpha redistribution
is integer tensor logic.

All public functions take a ModelBundle and a normalized ``[H, W, C]``
input on the model's device and return the per-channel attribution
``[H, W, C]``; reduce with :func:`to_saliency`.  The input is transposed to
NCHW once on entry and the result back once on exit.  Gradients are taken
with respect to the input only (the bundle's parameters are frozen).

``dtype=torch.bfloat16`` runs the sweep's forwards and backwards on a
bf16 copy of the model (``ModelBundle.cast``).  The interpolation images
are built in float32 and cast once a chunk; scores, gradients, the Riemann
mean and the products with the input stay float32.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.common import target_scores


def to_saliency(attr: torch.Tensor) -> np.ndarray:
    """[H, W, C] signed attribution -> [H, W] |sum over channels|."""
    return attr.sum(dim=-1).abs().cpu().numpy()


# ---------------------------------------------------------------------------
# the flat chunked sweep shared by every IG-family method, single and batched
# ---------------------------------------------------------------------------

def _fit_chunk(n: int, chunk: int) -> int:
    """The largest divisor of ``n`` that is at most ``chunk``."""
    chunk = min(chunk, n)
    while n % chunk:
        chunk -= 1
    return chunk


def _flat_grads(bundle, n: int, build, targets, chunk: int):
    """d logit[target] / d image for ``n`` images, one batched forward and
    backward per ``chunk`` of them (saliencyMethods.py:40-46 / 209-215).
    ``build(lo, hi)`` makes rows ``lo:hi`` ``[hi - lo, C, H, W]``, so a
    large sweep builds each chunk's images as it needs them; they run in
    the bundle's dtype.  ``targets``: one class, or int64 ``[n]``.
    Returns (grads ``[n, C, H, W]``, logits ``[n]``), both float32."""
    grads, logits = [], []
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        t = targets[lo:hi] if isinstance(targets, torch.Tensor) else targets
        g, s = bundle.score_and_grad(build(lo, hi).to(bundle.dtype), t)
        grads.append(g)
        logits.append(s)
    return torch.cat(grads), torch.cat(logits)


@torch.no_grad()
def _flat_logits(bundle, n: int, build, targets, chunk: int) -> torch.Tensor:
    """The float32 target logits ``[n]`` of the same sweep, forwards only."""
    out = []
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        t = targets[lo:hi] if isinstance(targets, torch.Tensor) else targets
        logits = bundle.apply(build(lo, hi).to(bundle.dtype)).float()
        out.append(target_scores(logits, t))
    return torch.cat(out)


def _interp(alphas: torch.Tensor, diff: torch.Tensor, base=None):
    """``build`` of the sweep over M paths: alphas ``[M, steps]``, diff
    (and base, if given) ``[M, C, H, W]``; row ``m * steps + k`` is
    ``base[m] + alphas[m, k] * diff[m]``, one fused multiply-add per
    element as XLA computes it (a separate multiply and add round twice,
    and a one-ulp shift of an image can cross a ReLU kink when the
    baseline is not zero).  The rows come back NCHW-contiguous whatever
    the strides of diff: a single image's diff is a view of its
    ``[H, W, C]`` input, and a channels-last batch makes cuDNN convert
    layouts around R101's convolutions on the H100 (PERF.md §6)."""
    steps = alphas.shape[1]
    flat = alphas.reshape(-1)

    def build(lo, hi):
        n = torch.arange(lo, hi, device=diff.device)
        a = flat[n].view(-1, 1, 1, 1)
        m = n // steps
        rows = a * diff[m] if base is None else torch.addcmul(base[m], a,
                                                              diff[m])
        return rows.contiguous()
    return build


def _unit_linspace(steps: int, dtype, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, steps)`` with xai_tpu's values: k * (1/(steps-1))
    in float32, endpoint exactly 1.  ``torch.linspace`` rounds some steps
    one ulp apart, which a non-zero baseline's path amplifies past
    float32 parity."""
    if steps == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    a = torch.arange(steps, dtype=dtype, device=device) * (1.0 / (steps - 1))
    a[-1] = 1.0
    return a


def _uniform_alphas(m: int, steps: int, like: torch.Tensor) -> torch.Tensor:
    return _unit_linspace(steps, torch.float32, like.device).expand(m, steps)


def _riemann_mean(grads: torch.Tensor, logits: torch.Tensor,
                  alpha_star: float) -> torch.Tensor:
    """grads ``[M, steps, C, H, W]``, logits ``[M, steps]`` ->
    ``[M, C, H, W]``: the mean over all steps (IG), or over the steps
    before the first logit above alpha_star x max (LIG,
    saliencyMethods.py:48-67; 1 step when none is, and a cutoff of 0 steps
    is clamped to 1)."""
    if alpha_star >= 1.0:
        return grads.mean(dim=1)
    above = logits > logits.amax(dim=1, keepdim=True) * alpha_star
    # argmax returns the first maximum: the first step above the cutoff
    first = above.to(torch.uint8).argmax(dim=1)
    cut = torch.where(above.any(dim=1), first, 1).clamp(min=1)
    w = (torch.arange(logits.shape[1], device=logits.device)[None]
         < cut[:, None]).to(grads.dtype)
    return torch.einsum("ms,mschw->mchw", w, grads) / cut.view(-1, 1, 1, 1)


def _ig_sweep(bundle, base, diff, targets, steps: int, alpha_star: float,
              chunk: int) -> torch.Tensor:
    """The Riemann means ``[M, C, H, W]`` of M uniform paths from base
    (zero when None) along diff."""
    m = diff.shape[0]
    grads, logits = _flat_grads(
        bundle, m * steps, _interp(_uniform_alphas(m, steps, diff), diff,
                                   base), targets, chunk)
    return _riemann_mean(grads.view((m, steps) + diff.shape[1:]),
                         logits.view(m, steps), alpha_star)


# ---------------------------------------------------------------------------
# plain gradient / input x gradient
# ---------------------------------------------------------------------------

def grad(bundle, x: torch.Tensor, target: int) -> torch.Tensor:
    """d logit[target] / d input (saliencyMethods.py:7-11)."""
    g, _ = bundle.score_and_grad(x.permute(2, 0, 1)[None], target)
    return g[0].permute(1, 2, 0)


def inp_x_grad(bundle, x: torch.Tensor, target: int) -> torch.Tensor:
    return x * grad(bundle, x, target)


# ---------------------------------------------------------------------------
# IG / LIG (saliencyMethods.py:13-72)
# ---------------------------------------------------------------------------

def _baseline_chw(baseline, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(baseline, dtype=x.dtype, device=x.device
                           ).expand_as(x).permute(2, 0, 1)


def ig(bundle, x: torch.Tensor, target: int, steps: int = 50,
       alpha_star: float = 1.0, baseline=0.0, chunk: int = None,
       dtype=None) -> torch.Tensor:
    """Integrated Gradients; ``alpha_star < 1`` gives LIG (LeftIG): truncate
    the Riemann sum at the first step whose logit exceeds
    alpha_star * max_logit (saliencyMethods.py:48-67)."""
    chunk = _fit_chunk(steps, chunk or min(bundle.meta.batch_size, steps))
    base = _baseline_chw(baseline, x)
    diff = x.permute(2, 0, 1) - base
    mean = _ig_sweep(bundle.cast(dtype), base[None], diff[None], target,
                     steps, alpha_star, chunk)[0]
    return (mean * diff).permute(1, 2, 0)


def lig(bundle, x: torch.Tensor, target: int, steps: int = 50,
        baseline=0.0, alpha_star: float = 0.9, chunk: int = None
        ) -> torch.Tensor:
    return ig(bundle, x, target, steps, alpha_star, baseline, chunk)


def ig_batch(bundle, xs: torch.Tensor, targets, steps: int = 50,
             chunk: int = 100, dtype=None) -> torch.Tensor:
    """IG of a batch of images with a zero baseline, xai_tpu's library
    ``ig_batch``: ``[B, H, W, C]`` inputs, one target each -> ``[B, H, W,
    C]``.  The image and interpolation axes fold into one sweep of
    ``B * steps`` rows, each ``alpha * x`` with the alphas of
    ``jnp.linspace(0, 1, steps)`` (both ends), ``chunk`` rows a forward
    and backward (stepped down until it divides ``B * steps``).  Each
    image's gradients are averaged, then multiplied by its float32 input;
    ``dtype=torch.bfloat16`` runs the sweep on the bundle's bf16 copy."""
    x = xs.permute(0, 3, 1, 2)
    tg = torch.as_tensor(targets, dtype=torch.int64, device=xs.device)
    mean = _ig_sweep(bundle.cast(dtype), None, x,
                     tg.view(-1).repeat_interleave(steps), steps, 1.0,
                     _fit_chunk(x.shape[0] * steps, chunk))
    return (mean * x).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# IDG (saliencyMethods.py:74-136, 226-314)
# ---------------------------------------------------------------------------

def _slopes(logits: torch.Tensor, d_alpha) -> torch.Tensor:
    """[M, steps] logits -> [M, steps] slopes, 0 at step 0."""
    return torch.cat([torch.zeros_like(logits[:, :1]),
                      torch.diff(logits, dim=1) / d_alpha], dim=1)


def _alpha_parameters(slopes: torch.Tensor, steps: int, step_size: float):
    """getAlphaParameters (saliencyMethods.py:264-314) as tensor logic, the
    counterpart of xai_tpu's ``_alpha_parameters``: the ``steps`` sample
    budget goes to the pilot's segments in proportion to their normalized
    slope.  Zero-sample segments do not advance the alpha window (the
    reference's ``continue`` at :302), so the non-zero segments take
    consecutive windows.  A flat slope trace divides 0 by 0 here, as it
    does in xai_tpu."""
    smin, smax = slopes.min(), slopes.max()
    s01 = (slopes - smin) / (smax - smin)
    s01[0] = 0.0
    placements_f = s01 / s01.sum() * steps
    placements = placements_f.to(torch.int32)          # truncates
    remaining = steps - placements.sum()

    # the leftover slots go to the largest truncated fractions among the
    # segments that truncated to zero (the reference marks the others -1,
    # :281-287); a stable sort reversed, as jnp.flip(jnp.argsort(...))
    marked = torch.where(placements != 0, -1.0, placements_f)
    order = torch.argsort(marked, stable=True).flip(0)
    slots = torch.arange(steps, device=slopes.device)
    rank = torch.empty_like(order)
    rank[order] = slots
    placements = placements + (rank < remaining).to(torch.int32)

    # segment window = rank among the non-zero segments
    win = torch.cumsum((placements > 0).to(torch.int64), 0) - 1
    # per sample slot: its segment; a gather clamps, as XLA's does
    cum = torch.cumsum(placements.to(torch.int64), 0)
    seg = torch.searchsorted(cum, slots, right=True).clamp(max=steps - 1)
    n_seg = placements[seg]
    within = slots - (cum[seg] - n_seg)
    # the reference's linspace(v, v + step, n + 1)[:n]: v + within*step/n
    substep = step_size / n_seg
    alphas = win[seg] * step_size + within * substep
    return alphas, substep


def _idg_sweep(bundle, base, diff, targets, steps: int, chunk: int):
    """IDG's two sweeps over M paths: a pilot of forwards on uniform alphas
    (getSlopes, :226-260), the alphas redistributed by its logit slopes,
    then the gradient sweep weighted by the new slopes times the substep
    (:117-124).  Returns the weighted means ``[M, C, H, W]``."""
    m = diff.shape[0]
    step_size = 1.0 / (steps - 1)
    pilot = _flat_logits(bundle, m * steps, _interp(
        _uniform_alphas(m, steps, diff), diff, base), targets, chunk)
    alphas, substep = (torch.stack(t) for t in zip(*(
        _alpha_parameters(s, steps, step_size)
        for s in _slopes(pilot.view(m, steps), step_size))))
    grads, logits = _flat_grads(bundle, m * steps,
                                _interp(alphas, diff, base), targets, chunk)
    weight = _slopes(logits.view(m, steps), torch.diff(alphas, dim=1)) \
        * substep
    return (grads.view((m, steps) + diff.shape[1:])
            * weight[:, :, None, None, None]).mean(dim=1)


def idg(bundle, x: torch.Tensor, target: int, steps: int = 50,
        baseline=0.0, chunk: int = None) -> torch.Tensor:
    """Importance-Directed Gradients (saliencyMethods.py:74-136)."""
    chunk = _fit_chunk(steps, chunk or min(bundle.meta.batch_size, steps))
    base = _baseline_chw(baseline, x)
    diff = x.permute(2, 0, 1) - base
    mean = _idg_sweep(bundle, base[None], diff[None], target, steps,
                      chunk)[0]
    return (mean * diff).permute(1, 2, 0)


# ---------------------------------------------------------------------------
# IDGI (saliencyMethods.py:139-181)
# ---------------------------------------------------------------------------

def _idgi_sweep(bundle, base, diff, targets, steps: int, chunk: int):
    """IDGI over M uniform paths: each step's squared gradient, normalized
    over the image, times the step's logit increase.  A zero-gradient step
    (a dead-ReLU zero baseline) is 0/0 in the reference and poisons the
    map with NaN; as in xai_tpu it contributes nothing instead.  Returns
    ``[M, C, H, W]``."""
    m = diff.shape[0]
    grads, logits = _flat_grads(
        bundle, m * steps, _interp(_uniform_alphas(m, steps, diff), diff,
                                   base), targets, chunk)
    d = torch.diff(logits.view(m, steps), dim=1)
    g2 = grads.view((m, steps) + diff.shape[1:])[:, :-1] ** 2
    denom = g2.sum(dim=(2, 3, 4), keepdim=True)
    term = torch.where(denom > 0, g2 * d[:, :, None, None, None] / denom,
                       0.0)
    return term.sum(dim=1)


def idgi(bundle, x: torch.Tensor, target: int, steps: int = 50,
         baseline=0.0, chunk: int = None) -> torch.Tensor:
    chunk = _fit_chunk(steps, chunk or min(bundle.meta.batch_size, steps))
    base = _baseline_chw(baseline, x)
    diff = x.permute(2, 0, 1) - base
    return _idgi_sweep(bundle, base[None], diff[None], target, steps,
                       chunk)[0].permute(1, 2, 0)


# ---------------------------------------------------------------------------
# SmoothGrad ensemble (saliencyMethods.py:184-205)
# ---------------------------------------------------------------------------

def sg_noise(x: torch.Tensor, samples: int, generator: torch.Generator,
             sigma_spread: float = 0.15) -> torch.Tensor:
    """``[samples, H, W, C]`` Gaussian noise of sd sigma_spread x (max -
    min) of the ``[H, W, C]`` image, drawn from ``generator`` (on the
    image's device).  The batched SmoothGrad draws each image's noise the
    same way, so the two paths agree on the same generators."""
    stdev = sigma_spread * (x.max() - x.min())
    return stdev * torch.randn((samples,) + tuple(x.shape), dtype=x.dtype,
                               device=x.device, generator=generator)


def _channel0(per_sample: torch.Tensor) -> torch.Tensor:
    """The reference's ``total_gradients[i], _, _ = IG(...)``
    (saliencyMethods.py:196-200) unpacks the [3, H, W] attribution over
    its channels: channel 0 broadcast to all three.  ``[..., C, H, W]``."""
    return per_sample[..., 0:1, :, :].expand_as(per_sample)


def smooth_grad(bundle, x: torch.Tensor, target: int, generator=None,
                attribution: str = "IG", steps: int = 50, baseline=0.0,
                samples: int = 25, sigma_spread: float = 0.15,
                reference_quirk: bool = True, dtype=None,
                noises=None) -> torch.Tensor:
    """Gaussian-noise ensemble around IG/LIG/IDG; sigma = spread*(max-min).

    IG and LIG fold the noise-sample axis into the interpolation sweep:
    one chunked sweep over samples*steps images.  IDG runs one IDG per
    sample (its alpha redistribution is per sample); ``dtype`` applies to
    IG and LIG, as in xai_tpu.  ``noises`` (``[samples, H, W, C]``)
    injects the absolute noise samples; otherwise they are drawn from
    ``generator`` (:func:`sg_noise`).  ``reference_quirk`` keeps channel 0
    only (:func:`_channel0`); False gives the all-channel mean."""
    if noises is None:
        if generator is None:
            raise ValueError("smooth_grad needs a generator or noises")
        noises = sg_noise(x, samples, generator, sigma_spread)
    else:
        noises = torch.as_tensor(noises, dtype=x.dtype, device=x.device)
        samples = int(noises.shape[0])

    if attribution in ("IG", "LIG"):
        alpha_star = 1.0 if attribution == "IG" else 0.9
        chunk = _fit_chunk(samples * steps,
                           min(bundle.meta.batch_size, steps))
        base = _baseline_chw(baseline, x)
        diff = (x[None] + noises).permute(0, 3, 1, 2) - base[None]
        per_sample = _ig_sweep(
            bundle.cast(dtype), base.expand_as(diff), diff, target, steps,
            alpha_star, chunk) * diff
        if reference_quirk:
            per_sample = _channel0(per_sample)
        return per_sample.mean(dim=0).permute(1, 2, 0)

    if attribution != "IDG":
        raise ValueError(attribution)
    total = torch.zeros_like(x)
    for i in range(samples):
        a = idg(bundle, x + noises[i], target, steps, baseline,
                chunk=max(1, int(steps / 4)))
        if reference_quirk:
            a = a[..., 0:1].expand_as(a)
        total = total + a
    return total / samples
