"""LRP transformer attribution (t_attr): Chefer-style relevance
propagation.

Counterpart of ``xai_tpu/methods/vit_lrp.py`` (reference:
util/attribution_methods/VIT_LRP/ViT_LRP_timm.py:633-760 and
VIT_LRP/util/layers_ours.py:35-286, alpha-1-beta-0 rules).  The relevance
sweep runs in reverse over the standard model's taps; the block internals
that the taps do not hold are recomputed from the module's weights, and
every rule is a closed-form product.  With alpha = 1 the Linear rule needs
only the activator term.

Rules (layers_ours.py): safe_divide (:10-13); Linear alpha1beta0
(:215-238); RelPropSimple for the two attention matmuls (:50-60, halved
as in Attention.relprop, ViT_LRP_timm.py:361-376); Add with
sum-renormalization (:104-125); Clone (:156-175); IndexSelect pool
(:134-152); LayerNorm, GELU, Softmax and Dropout pass relevance unchanged
(:70-82).

Like ``methods/vit_explain.py``, every public function takes a batch of
``[B, H, W, C]`` images and one target a row, and returns ``[B, P, P]``
(``lrp_full``: ``[B, H, W]``); the Add rule's sums and the z^B rule's
bounds are taken per image, as xai_tpu takes them over its batch of one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .vit_explain import (_cls_patch_grid, _collect, _prepare, _taps,
                          rollout_residual)


def _safe_divide(a, b):
    den = b.clamp(min=1e-9) + b.clamp(max=1e-9)
    den = den + (den == 0).to(den.dtype) * 1e-9
    return a / den * (b != 0)


def _linear_rp(R, X, K):
    """The alpha = 1, beta = 0 Linear rule; K is the kernel ``[in, out]``
    (an ``nn.Linear`` weight transposed)."""
    pw = K.clamp(min=0)
    nw = K.clamp(max=0)
    px = X.clamp(min=0)
    nx = X.clamp(max=0)
    Z = px @ pw + nx @ nw
    S = _safe_divide(R, Z)
    return px * (S @ pw.T) + nx * (S @ nw.T)


def _image_sum(t):
    """The sum over all but the batch axis, kept broadcastable."""
    return t.sum(dim=tuple(range(1, t.dim())), keepdim=True)


def _add_rp(R, X0, X1):
    Z = X0 + X1
    S = _safe_divide(R, Z)
    a = X0 * S
    b = X1 * S
    a_sum, b_sum = _image_sum(a), _image_sum(b)
    tot = a_sum.abs() + b_sum.abs()
    r_sum = _image_sum(R)
    a_fact = _safe_divide(a_sum.abs(), tot) * r_sum
    b_fact = _safe_divide(b_sum.abs(), tot) * r_sum
    a = a * _safe_divide(a_fact, _image_sum(a))
    b = b * _safe_divide(b_fact, _image_sum(b))
    return a, b


def _clone_rp(R0, R1, X):
    return X * (_safe_divide(R0, X) + _safe_divide(R1, X))


def _matmul2_rp(R, attn, v):
    """``attn @ v`` RelPropSimple, halved (ViT_LRP:361-364)."""
    S = _safe_divide(R, attn @ v)
    c_attn = S @ v.transpose(-2, -1)
    c_v = attn.transpose(-2, -1) @ S
    return (attn * c_attn) / 2, (v * c_v) / 2


def _matmul1_rp(R, q, k):
    """``q @ k^T`` RelPropSimple, halved (:372-375)."""
    S = _safe_divide(R, q @ k.transpose(-2, -1))
    c_q = S @ k
    c_k = S.transpose(-2, -1) @ q
    return (q * c_q) / 2, (k * c_k) / 2


def _layernorm(x, ln, eps=1e-6):
    """The two-pass LayerNorm xai_tpu writes out for the sweep."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * ln.scale + ln.bias


def _dense(x, lin):
    return x @ lin.weight.T + lin.bias


def _attn_cams_and_bottom(bundle, taps, tg):
    """The full relevance sweep from the ``[B]`` targets' one-hot logits:
    per-block attention relevance ``[L, B, H, N, N]`` and the relevance
    at the bottom of the blocks, ``[B, N, D]``."""
    model = bundle.module
    cfg = model.cfg
    b, n = taps["block_out"].shape[1:3]
    h = cfg.num_heads
    d = cfg.embed_dim // h

    # head -> pool -> norm (identity)
    normed = _layernorm(taps["block_out"][-1], model.norm)
    R = F.one_hot(tg, cfg.num_classes).to(normed.dtype)
    R = _linear_rp(R, normed[:, 0], model.head.weight.T)
    cam = torch.zeros_like(normed)
    cam[:, 0] = R                                      # IndexSelect scatter

    attn_cams = []
    for i, p in reversed(list(enumerate(model.blocks()))):
        xin = taps["block_in"][i]
        x_plus = taps["input_plus_attn"][i]
        attn = taps["attn"][i]
        v = taps["v"][i]
        # recompute the remaining internals
        n1 = _layernorm(xin, p.norm1)
        qkv = _dense(n1, p.attn.qkv).view(b, n, 3, h, d)
        q, k = qkv[:, :, 0].transpose(1, 2), qkv[:, :, 1].transpose(1, 2)
        out_pre_proj = (attn @ v).transpose(1, 2).reshape(b, n, -1)
        n2 = _layernorm(x_plus, p.norm2)
        hact = F.gelu(_dense(n2, p.mlp_fc1))

        # Block.relprop (ViT_LRP_timm.py:434-447)
        cam1, cam2 = _add_rp(cam, x_plus, taps["mlp_val"][i])
        cam2 = _linear_rp(cam2, hact, p.mlp_fc2.weight.T)
        cam2 = _linear_rp(cam2, n2, p.mlp_fc1.weight.T)
        cam = _clone_rp(cam1, cam2, x_plus)

        cam1, cam2 = _add_rp(cam, xin, taps["attn_out"][i])
        # Attention.relprop (:355-379)
        cam_a = _linear_rp(cam2, out_pre_proj, p.attn.proj.weight.T)
        cam_a = cam_a.view(b, n, h, d).transpose(1, 2)
        cam_attn, cam_v = _matmul2_rp(cam_a, attn, v)
        attn_cams.append(cam_attn)
        cam_q, cam_k = _matmul1_rp(cam_attn, q, k)
        cam_qkv = torch.stack([cam_q, cam_k, cam_v], dim=2)   # [B,H,3,N,d]
        cam_qkv = cam_qkv.permute(0, 3, 2, 1, 4).reshape(b, n, 3 * h * d)
        cam2 = _linear_rp(cam_qkv, n1, p.attn.qkv.weight.T)
        cam = _clone_rp(cam1, cam2, xin)

    return torch.stack(attn_cams[::-1]), cam


def lrp_rollout(bundle, x, targets, start_layer: int = 0):
    """relprop method='rollout' (ViT_LRP_timm.py:651-661): the positive
    head-mean attention relevance rolled out with the residual rule."""
    xb, tg = _prepare(bundle, x, targets)
    cams, _ = _attn_cams_and_bottom(bundle, _taps(bundle, xb), tg)
    ro = rollout_residual(cams.clamp(min=0).mean(2), start_layer)
    return _cls_patch_grid(ro[:, 0])


def lrp_layer(bundle, x, targets, layer: int = -1,
              is_ablation: bool = False):
    """relprop method='last_layer' / 'second_layer'
    (ViT_LRP_timm.py:726-745): one block's attention relevance CLS row,
    optionally gradient-weighted."""
    xb, tg = _prepare(bundle, x, targets)
    if is_ablation:
        taps, grads = _collect(bundle, xb, tg)
    else:
        taps = _taps(bundle, xb)
    cam = _attn_cams_and_bottom(bundle, taps, tg)[0][layer]
    if is_ablation:
        cam = grads[layer] * cam
    return _cls_patch_grid(cam.clamp(min=0).mean(1)[:, 0])


def _conv_zb_rp(R_tokens, x_img, weight, patch: int):
    """The z^B rule for the patch-embedding conv (layers_ours.py Conv2d
    branch for 3-channel inputs): the bounds L and H are each image's
    input min and max.  R_tokens ``[B, D, P, P]``, x_img ``[B, C, H, W]``,
    weight OIHW; the transposed conv is the conv's VJP (stride = kernel,
    so the patches do not overlap)."""
    pw = weight.clamp(min=0)
    nw = weight.clamp(max=0)
    lo = x_img.amin(dim=(1, 2, 3), keepdim=True).expand_as(x_img)
    hi = x_img.amax(dim=(1, 2, 3), keepdim=True).expand_as(x_img)

    def conv(v, w):
        return F.conv2d(v, w, stride=patch)

    def conv_t(s, w):
        return F.conv_transpose2d(s, w, stride=patch)

    za = conv(x_img, weight) - conv(lo, pw) - conv(hi, nw) + 1e-9
    S = R_tokens / za
    return x_img * conv_t(S, weight) - lo * conv_t(S, pw) - hi * conv_t(S, nw)


def lrp_full(bundle, x, targets):
    """relprop method='full' (ViT_LRP_timm.py:645-651): relevance carried
    through the positional-embedding Add and the patch-embedding conv (z^B
    rule) to the pixels.  Returns ``[B, H, W]`` (summed over channels)."""
    xb, tg = _prepare(bundle, x, targets)
    model = bundle.module
    cfg = model.cfg
    taps = _taps(bundle, xb)
    _, bottom = _attn_cams_and_bottom(bundle, taps, tg)
    pos = model.pos_embed
    x0 = taps["patch_embedding"] - pos                  # tokens pre-pos-add
    cam_x, _ = _add_rp(bottom, x0, pos.expand_as(x0))
    r_tokens = cam_x[:, 1:].transpose(1, 2).reshape(
        xb.shape[0], cfg.embed_dim, cfg.grid, cfg.grid)
    return _conv_zb_rp(r_tokens, xb, model.patch_embed.weight,
                       cfg.patch).sum(1)


def transformer_attribution(bundle, x, targets, start_layer: int = 0):
    """LRP.generate_LRP(method='transformer_attribution')
    (ViT_explanation_generator.py:107-133 + ViT_LRP_timm.py:665-684): per
    block (grad * attn_cam).clamp(0).mean(heads), residual rollout, CLS
    row.  The sweep reads the taps of the gradient's probed forward (a
    zero probe leaves every map as it is)."""
    xb, tg = _prepare(bundle, x, targets)
    taps, grads = _collect(bundle, xb, tg)
    cams, _ = _attn_cams_and_bottom(bundle, taps, tg)
    weighted = (grads * cams).clamp(min=0).mean(2)     # [L, B, N, N]
    return _cls_patch_grid(rollout_residual(weighted, start_layer)[:, 0])
