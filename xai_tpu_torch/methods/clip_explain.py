"""CLIP explainers: Grad-ECLIP (and its ablations), MaskCLIP,
self-attention, Grad-CAM, GAME relevance, CLIP-LRP and attention rollout.

Counterpart of ``xai_tpu/methods/clip_explain.py`` (reference:
util/attribution_methods/CLIP/generate_emap.py).  Two primitives carry
them all:

- :func:`encode_dense`: the last visual block as one 1-head attention over
  the full width, exposing q, k, v, the attention map, the attention
  output before ``out_proj`` and the value-path embedding ``v_final``
  (clip_encode_dense, generate_emap.py:309-377);
- :func:`mm_grads`: the gradients of ``trace(logits_per_image)`` with
  respect to the additive zero probes on every visual and text attention
  map (mm_interpret, :133-268).

Every public function takes a batch: normalized ``[B, H, W, C]`` images on
the model's device, with one caption a row (``txt_emb`` ``[B, E]``
normalized text embeddings, ``text_tokens`` ``[B, L]`` ids: the drivers'
target captions; xai_tpu's single-image functions also sum over several
captions, which no driver passes), and returns ``[B, P, P]`` patch maps
(no resize: the registry upsamples).  xai_tpu computes each image as a batch
of one and batches by vmapping it; every reduction here (grad_eclip's
min-max of ``cos_qk``, the norms, the relevance chain, Grad-CAM's token
mean) is taken per image, so a row of a batch is the image alone.  The
gradient of ``trace(logits_per_image)`` over B images and their B
captions is each image's own: diagonal entry i depends only on image i
and caption i.

Arithmetic follows xai_tpu's: the explainers' own LayerNorm is the
two-pass ``((x - mu) ** 2).mean()`` with ``rsqrt`` (the model's is flax's
fast variance, ``models/vit.py LayerNorm``); the dense attention scales
``q`` before the product and accumulates in float32 (``preferred_element_
type``); products of mixed dtypes promote as ``jnp`` promotes them
(:func:`mm`), so on a bf16 copy of the model the float32 parts of
xai_tpu's bf16 path (the tail after the float32 dense attention, the
gradients of the float32 probes, the relevance chains) are float32 here
too.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import clip as clipmod
from ..utils import trace


# ---------------------------------------------------------------------------
# arithmetic as xai_tpu writes it
# ---------------------------------------------------------------------------

def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two, as ``jnp`` computes a
    product of a bf16 and a float32 array."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def dense(x: torch.Tensor, lin: torch.nn.Linear) -> torch.Tensor:
    """``x @ kernel + bias`` of an ``nn.Linear`` (``kernel`` is its
    transposed weight)."""
    return mm(x, lin.weight.T) + lin.bias


def ln(x: torch.Tensor, norm, eps: float = 1e-5) -> torch.Tensor:
    """The explainers' LayerNorm: two-pass variance, ``rsqrt``, then the
    module's ``scale`` and ``bias``."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * norm.scale + norm.bias


def mlp(x: torch.Tensor, blk) -> torch.Tensor:
    return dense(clipmod.quick_gelu(dense(x, blk.mlp_c_fc)), blk.mlp_c_proj)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _prepare(bundle, x):
    """``[B, H, W, C]`` -> NCHW in the bundle's dtype."""
    return x.permute(0, 3, 1, 2).contiguous().to(bundle.dtype)


def _grid(rows: torch.Tensor) -> torch.Tensor:
    """``[B, P*P]`` patch rows -> ``[B, P, P]``."""
    p = int(round(rows.shape[-1] ** 0.5))
    return rows.reshape(rows.shape[0], p, p)


# ---------------------------------------------------------------------------
# the dense last block (clip_encode_dense)
# ---------------------------------------------------------------------------

class DenseOutputs(NamedTuple):
    outputs: torch.Tensor      # [B, N, E] projected tokens
    v_final: torch.Tensor      # [B, N-1, E] value-path embedding
    x_in: torch.Tensor         # [B, N, W] input to the last block
    v: torch.Tensor            # [B, N, W] raw values
    q_out: torch.Tensor        # [B, N, W] out_proj(q)
    k_out: torch.Tensor        # [B, N, W] out_proj(k)
    attn: torch.Tensor         # [B, N, N] 1-head attention
    att_output: torch.Tensor   # [B, N, W] attention output before out_proj


def _dense_qkv(x_in, blk):
    qkv = dense(ln(x_in, blk.ln_1), blk.attn.in_proj)
    return qkv.chunk(3, dim=-1)


def _dense_attention(q, k, v, f32: bool):
    """One head over the full width W, scaled before the product by
    W^-0.5 (the reference's attention_layer(q, k, v, 1),
    generate_emap.py:288-306); ``f32``: float32 products and sums, as
    xai_tpu's ``preferred_element_type=float32``."""
    qs = q * float(q.shape[-1]) ** -0.5
    if f32:
        qs, k = qs.float(), k.float()
    attn = torch.softmax(mm(qs, k.transpose(-2, -1)), dim=-1)
    return attn, mm(attn, v.float() if f32 else v)


def _dense_tail(att_output, x_in, blk, visual):
    """The attention output -> the projected tokens (the differentiable
    tail of grad_eclip and Grad-CAM)."""
    x = dense(att_output, blk.attn.out_proj) + x_in
    x = x + mlp(ln(x, blk.ln_2), blk)
    return mm(ln(x, visual.ln_post), visual.proj)


def _last(bundle):
    visual = bundle.module.visual
    return visual, visual.blocks()[-1]


@torch.no_grad()
def encode_dense(bundle, x) -> DenseOutputs:
    visual, blk = _last(bundle)
    trace.count("model_rows", x.shape[0])
    x_in = visual(_prepare(bundle, x), stop_before_last=True)
    q, k, v = _dense_qkv(x_in, blk)
    attn, att_output = _dense_attention(q, k, v, f32=True)
    outputs = _dense_tail(att_output, x_in, blk, visual)
    q_out, k_out, v_out = (dense(t, blk.attn.out_proj) for t in (q, k, v))
    v_final = v_out + x_in
    v_final = v_final + mlp(ln(v_final, blk.ln_2), blk)
    v_final = mm(ln(v_final, visual.ln_post), visual.proj)
    return DenseOutputs(outputs, v_final[:, 1:], x_in, v, q_out, k_out,
                        attn, att_output)


def _cosine(outputs, txt):
    """The cosine of each image's CLS embedding with its caption ``[B,
    E]`` -> ``[B]``."""
    img = _unit(outputs[:, 0])
    return mm(img[:, None, :], txt[:, :, None])[:, 0, 0]


def grad_eclip(bundle, x, txt_emb, withksim: bool = True,
               withgrad: bool = True) -> torch.Tensor:
    """Grad-ECLIP (generate_emap.py:453-486): for the caption's cosine c,
    relu(sum_D dc/d(att_output)[CLS] * v[patches] * minmax(cos(q_cls,
    k_patch))); ``withksim=False`` drops the q-k weighting (eclip_wo),
    ``withgrad=False`` the gradient (eclip_nograd)."""
    d = encode_dense(bundle, x)
    visual, blk = _last(bundle)
    if withksim:
        q_cls = _unit(d.q_out[:, 0])
        k_patch = _unit(d.k_out[:, 1:])
        cos_qk = (k_patch @ q_cls[:, :, None])[..., 0]
        lo = cos_qk.amin(-1, keepdim=True)
        hi = cos_qk.amax(-1, keepdim=True)
        cos_qk = (cos_qk - lo) / (hi - lo)
    else:
        cos_qk = torch.ones(d.v.shape[:2], device=d.v.device)[:, 1:]
    v = d.v[:, 1:]
    if withgrad:
        att = d.att_output.detach().requires_grad_(True)
        with torch.enable_grad():
            c = _cosine(_dense_tail(att, d.x_in, blk, visual), txt_emb)
            (grad,) = torch.autograd.grad(c.sum(), att)
        v = grad[:, :1] * v
    # xai_tpu adds the relu'd map to a float32 zero total
    return _grid((v * cos_qk[..., None]).sum(-1).clamp(min=0).float())


def mask_clip(bundle, x, txt_emb) -> torch.Tensor:
    """MaskCLIP (generate_emap.py:500-530): cosine(v_final, caption)
    weighted by the cosine of each patch key with the CLS key."""
    d = encode_dense(bundle, x)
    cos_v = mm(_unit(d.v_final), txt_emb[:, :, None])[..., 0]
    k_cls = _unit(d.k_out[:, 0])
    cos_k = (_unit(d.k_out[:, 1:]) @ k_cls[:, :, None])[..., 0]
    return _grid(cos_v * cos_k)


def self_attn(bundle, x) -> torch.Tensor:
    """selfattn (evaluatePerturbation.py:423-424): the CLS row of the
    dense 1-head attention."""
    return _grid(encode_dense(bundle, x).attn[:, 0, 1:])


def clip_grad_cam(bundle, x, txt_emb) -> torch.Tensor:
    """Grad-CAM on the last block's input (generate_emap.py:488-499): the
    token-mean gradient of the caption's cosine, through the dense block
    recomputed without float32 accumulation, as xai_tpu recomputes it."""
    d = encode_dense(bundle, x)
    visual, blk = _last(bundle)
    x_in = d.x_in.detach().requires_grad_(True)
    with torch.enable_grad():
        q, k, v = _dense_qkv(x_in, blk)
        _, att_output = _dense_attention(q, k, v, f32=False)
        c = _cosine(_dense_tail(att_output, x_in, blk, visual), txt_emb)
        (grad,) = torch.autograd.grad(c.sum(), x_in)
    w = grad.mean(1, keepdim=True)
    return _grid((w * d.x_in[:, 1:]).sum(-1).clamp(min=0))


# ---------------------------------------------------------------------------
# probed full-model relevance (GAME / LRP / rollout)
# ---------------------------------------------------------------------------

def mm_grads(bundle, x, text_tokens):
    """(visual taps, text taps, visual probe gradients, text probe
    gradients) of ``trace(logits_per_image)`` over the images and their
    captions (mm_interpret's loss, generate_emap.py:134-144); the
    gradients are ``[L, B, H, N, N]``.  The probes are float32, cast to
    the compute dtype inside the attention, as xai_tpu's are."""
    xb = _prepare(bundle, x)
    cfg = bundle.extras["cfg"]
    text_tokens = torch.as_tensor(text_tokens, dtype=torch.int64,
                                  device=xb.device)
    vis = clipmod.zero_probes(cfg, "visual", xb.shape[0], device=xb.device)
    txt = clipmod.zero_probes(cfg, "text", text_tokens.shape[0],
                              seq=text_tokens.shape[1], device=xb.device)
    pv = vis["attn"].requires_grad_(True)
    pt = txt["attn"].requires_grad_(True)
    trace.count("model_rows", xb.shape[0])
    with torch.enable_grad():
        lpi, _, vtap, ttap = bundle.module(xb, text_tokens,
                                           vis_probes={"attn": pv},
                                           txt_probes={"attn": pt},
                                           taps=True)
        gv, gt = torch.autograd.grad(torch.trace(lpi), (pv, pt))
    detach = lambda taps: {k: v.detach() for k, v in taps.items()}
    return detach(vtap), detach(ttap), gv, gt


def relevance(attn, grads, start_layer: int):
    """R = I + sum over the blocks from ``start_layer`` of (grad *
    attn).clamp(0).mean(heads) @ R (mm_interpret :154-170); ``attn``,
    ``grads``: ``[L, B, H, N, N]`` -> ``[B, N, N]``."""
    n = attn.shape[-1]
    r = torch.eye(n, dtype=attn.dtype, device=attn.device)[None]
    for i in range(max(start_layer, 0), attn.shape[0]):
        cam = (grads[i] * attn[i]).clamp(min=0).mean(1)
        r = r + mm(cam, r)
    return r


def game(bundle, x, text_tokens) -> torch.Tensor:
    """GAME (mm_interpret at its default start, the last block): the
    image relevance of each image with its caption."""
    vtap, _, gv, _ = mm_grads(bundle, x, text_tokens)
    last = bundle.extras["cfg"].vision_layers - 1
    return _grid(relevance(vtap["attn"], gv, last)[:, 0, 1:])


def clip_lrp(bundle, x, text_tokens):
    """clip_lrp (generate_emap.py:207-268): grad * attn relevance over
    every block of both towers.  Returns (text relevance ``[B, L, L]``,
    image relevance ``[B, P, P]``)."""
    vtap, ttap, gv, gt = mm_grads(bundle, x, text_tokens)
    r_txt = relevance(ttap["attn"], gt, 0)
    return r_txt, _grid(relevance(vtap["attn"], gv, 0)[:, 0, 1:])


@torch.no_grad()
def clip_rollout(bundle, x) -> torch.Tensor:
    """The driver's CLIP rollout (evaluatePerturbation.py:418-422):
    mm_interpret(rollout=True) keeps the head-mean attention of the last
    block only, so this is that matrix plus I, row-normalized, CLS row
    (compute_rollout_attention on one matrix); xai_tpu's takes the
    caption's ids and reads none of them."""
    _, taps = bundle.apply_taps(_prepare(bundle, x))
    a = taps["attn"][-1].mean(1)
    n = a.shape[-1]
    aug = a + torch.eye(n, device=a.device)
    aug = aug / aug.sum(-1, keepdim=True)
    return _grid(aug[:, 0, 1:])
