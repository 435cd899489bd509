"""M2IB: multi-modal information bottleneck attribution.

Counterpart of ``xai_tpu/methods/clip_m2ib.py`` (reference:
util/attribution_methods/CLIP/M2IB/scripts/{iba,methods}.py).  A
variational bottleneck t = lambda * h + (1 - lambda) * eps, eps ~ N(0, 1),
sits after visual block ``vlayer`` (default 9); lambda = sigmoid(alpha)
starts at alpha = 5 and takes 10 Adam steps (lr 1, 10 noise rows a step)
on beta * KL[N(lambda h, (1 - lambda)^2) || N(0, 1)] - cos(text, image).
The saliency is the per-token KL capacity of the last forward, that is of
the alpha before the final update, as the reference's buffer keeps it
(iba.py:180-188); CLS dropped, upsampled bilinearly, min-max normalized
per image.

The update is optax's Adam written out (``mas_calibrate.Adam``), not
``torch.optim.Adam``, whose bias correction rounds differently.  Each
image draws its noise from its own ``torch.Generator``; ``noises=``
injects them (the tests feed xai_tpu's draws).  A batch of B images runs
the suffix on B x 10 rows at once: each image's loss depends on its own
alpha only, so the gradient of the sum is each image's own.

The prefix is the model (flax's LayerNorm); the suffix uses the
explainers' two-pass LayerNorm, as xai_tpu's does.  ``vlayer`` past the
last block keeps xai_tpu's arithmetic: its tap index clamps to the last
block (JAX indexing) and the suffix is empty, which the slices below give
too.  Under a bf16 copy of the model, alpha, the noise, the Adam state,
everything after the bottleneck and the capacity are float32.  xai_tpu's
capacity is bf16 there, by accident: its alpha is weakly typed
(``jnp.full`` of a Python float), so ``h * lambda`` keeps the hidden
states' bf16, and the capacity's ``1 + log(var) - mu^2 - var`` cancels to
a few bf16 ulps: its bf16 map ranks like noise against its float32 one
(Spearman 0.04-0.65 on its tiny test CLIP).  The port keeps the capacity
float32 (0.9998), a recorded deviation (ROADMAP.md section C).
"""
from __future__ import annotations

import torch

from ..ops.resize import resize_bilinear
from ..utils import trace
from .clip_explain import _prepare, _unit, ln, mlp, mm
from .clip_surgery import mha
from .mas_calibrate import Adam


@torch.no_grad()
def visual_prefix(bundle, xb, vlayer: int) -> torch.Tensor:
    """The output of visual blocks 0..vlayer ``[B, N, W]``."""
    visual = bundle.module.visual
    trace.count("model_rows", xb.shape[0])
    y = visual.embed(xb)
    for blk in visual.blocks()[:vlayer + 1]:
        y, _ = blk(y)
    return y


def visual_suffix(bundle, h, vlayer: int) -> torch.Tensor:
    """The CLS embedding ``[R, E]`` of ``[R, N, W]`` hidden states run
    through the blocks after ``vlayer``, ``ln_post`` and the
    projection."""
    visual = bundle.module.visual
    y = h
    for blk in visual.blocks()[vlayer + 1:]:
        _, a = mha(ln(y, blk.ln_1), blk.attn, visual.cfg.vision_heads,
                   surgery=False)
        y = y + a
        y = y + mlp(ln(y, blk.ln_2), blk)
    return mm(ln(y, visual.ln_post), visual.proj)[:, 0]


# the reference's optimisation (iba.py, methods.py): Adam steps, noise rows
# a step, the capacity's weight and the learning rate
STEPS, ROWS, BETA, LR = 10, 10, 0.1, 1.0


def m2ib_noise(generator: torch.Generator, tokens: int,
               width: int) -> torch.Tensor:
    """One image's bottleneck draws ``[STEPS, ROWS, tokens, width]``."""
    return torch.randn((STEPS, ROWS, tokens, width), generator=generator,
                       device=generator.device)


def _capacity(h, lam):
    """The per-element KL capacity (float32 lambda: float32 on a bf16
    copy too)."""
    mu = h * lam
    var = (1 - lam) ** 2
    return -0.5 * (1 + torch.log(var) - mu ** 2 - var)


def vision_heatmap_iba(bundle, x, txt_emb, vlayer: int = 9,
                       generators=None, noises=None) -> torch.Tensor:
    """m2ib_clip_map: ``[B, H, W]`` min-max normalized maps of ``[B, H,
    W, C]`` images with their captions ``txt_emb`` ``[B, E]``, upsampled
    to the input's size.  ``noises``: ``[B, STEPS, ROWS, N, W]`` injected
    draws, else each image's :func:`m2ib_noise` from ``generators``."""
    xb = _prepare(bundle, x)
    cfg = bundle.extras["cfg"]
    h = visual_prefix(bundle, xb, vlayer)
    if noises is None:
        noises = torch.stack([m2ib_noise(g, cfg.tokens, cfg.vision_width)
                              for g in generators])
    noises = torch.as_tensor(noises, dtype=torch.float32, device=h.device)
    txt_n = _unit(txt_emb)[:, None]                       # [B, 1, E]
    alpha = torch.full(h.shape, 5.0, device=h.device)
    adam = Adam(LR, alpha)
    b = h.shape[0]
    for s in range(STEPS):
        alpha.requires_grad_(True)
        with torch.enable_grad():
            lam = torch.sigmoid(alpha)
            cap = _capacity(h, lam)
            eps = noises[:, s]                            # [B, R, N, W]
            t = (h * lam)[:, None] + (1 - lam[:, None]) * eps
            emb = visual_suffix(bundle, t.flatten(0, 1), vlayer)
            emb_n = _unit(emb).view(b, eps.shape[1], -1)
            fitting = (emb_n * txt_n).sum(-1).mean(1)
            loss = BETA * cap.flatten(1).mean(1) - fitting
            (g,) = torch.autograd.grad(loss.sum(), alpha)
        cap_fwd = cap.detach()                            # this forward's
        alpha = adam.step(alpha.detach(), g)
    sal = torch.nan_to_num(cap_fwd).sum(-1)[:, 1:]
    p = cfg.grid
    up = resize_bilinear(sal.view(b, p, p), (x.shape[1], x.shape[1]))
    lo = up.flatten(1).amin(1)[:, None, None]
    hi = up.flatten(1).amax(1)[:, None, None]
    return (up - lo) / (hi - lo)
