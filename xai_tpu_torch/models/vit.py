"""timm-style Vision Transformer with a tap + probe API, as ``nn.Module``s.

Counterpart of ``xai_tpu/models/vit.py``, NCHW at the boundary.  The
forward optionally

- returns a ``taps`` dict of stacked per-block intermediates (attention
  maps and logits, values, block inputs and outputs, input + attention,
  MLP values, the patch embedding), everything the explainers of
  ``methods/vit_explain.py`` and ``methods/vit_lrp.py`` read;
- takes additive zero ``probes`` on the post-softmax attention of each
  block and on the patch embedding, so that ``torch.autograd.grad`` with
  respect to a probe is the gradient with respect to that map.

Submodule and parameter names follow the JAX parameter tree
(``patch_embed``, ``cls_token``, ``pos_embed``, ``block{i}`` with
``norm1``, ``attn.qkv``, ``attn.proj``, ``norm2``, ``mlp_fc1``,
``mlp_fc2``; ``norm``, ``head``; LayerNorm ``scale`` and ``bias``), so
the weight carry of ``convert/from_jax.py`` is a rename and a transpose.

The attention is written out (the explainers need the post-softmax map as
a tap and the probe added to it), with xai_tpu's order of operations:
logits ``(q @ k^T) * scale``, softmax, probe, ``@ v``, all in the compute
dtype (bf16 on a cast copy, as xai_tpu keeps its bf16 path).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.preprocess import VIT_MEAN, VIT_STD
from .common import ModelBundle, ModelMeta, lecun_init_


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    img_hw: int = 224

    @property
    def tokens(self) -> int:
        return (self.img_hw // self.patch) ** 2 + 1

    @property
    def grid(self) -> int:
        return self.img_hw // self.patch


CONFIGS = {
    "vit_tiny_patch16_224": ViTConfig(16, 192, 12, 3),
    "vit_small_patch16_224": ViTConfig(16, 384, 12, 6),
    "vit_small_patch32_224": ViTConfig(32, 384, 12, 6),
    "vit_base_patch8_224": ViTConfig(8, 768, 12, 12),
    "vit_base_patch16_224": ViTConfig(16, 768, 12, 12),
    "vit_base_patch32_224": ViTConfig(32, 768, 12, 12),
    "vit_large_patch16_224": ViTConfig(16, 1024, 24, 16),
    "vit_large_patch32_224": ViTConfig(32, 1024, 24, 16),
}
CLI_ARCH = {"VIT16": "vit_base_patch16_224", "VIT32": "vit_base_patch32_224",
            "VIT8": "vit_base_patch8_224"}


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm(epsilon=1e-6)`` as flax computes it: float32
    statistics with the fast variance max(0, E[x^2] - E[x]^2), then
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, cast
    back to the compute dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 * x32).mean(-1, keepdim=True) - mu * mu).clamp(min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        y = (x32 - mu) * mul + self.bias.float()
        return y.to(torch.promote_types(x.dtype, self.scale.dtype))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, probe=None):
        b, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).view(b, n, 3, h, c // h)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        # scale after the product, as xai_tpu's einsum(q, k) * scale
        logits = (q @ k.transpose(-2, -1)) * (c // h) ** -0.5
        attn = torch.softmax(logits, dim=-1)
        if probe is not None:
            attn = attn + probe
        out = self.proj((attn @ v).transpose(1, 2).reshape(b, n, c))
        return out, {"attn": attn, "attn_logits": logits, "v": v,
                     "attn_out": out}


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x, probe=None):
        attn_in = self.norm1(x)
        a, tap = self.attn(attn_in, probe)
        x_plus_attn = x + a
        mlp_val = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x_plus_attn))))
        out = x_plus_attn + mlp_val
        tap.update({"block_in": x, "norm1_out": attn_in,
                    "input_plus_attn": x_plus_attn, "mlp_val": mlp_val,
                    "block_out": out})
        return out, tap


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = nn.Conv2d(3, d, cfg.patch, stride=cfg.patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.tokens, d))
        for i in range(cfg.depth):
            setattr(self, f"block{i}", Block(d, cfg.num_heads, cfg.mlp_ratio))
        self.norm = LayerNorm(d)
        self.head = nn.Linear(d, cfg.num_classes)

    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.cfg.depth)]

    def forward(self, x, taps: bool = False, probes: Optional[dict] = None,
                token_indices: Optional[torch.Tensor] = None):
        """x: ``[B, 3, H, W]``.  ``probes``: optional ``{"attn": per-block
        probes (a ``[L, B, H, N, N]`` tensor, or a list whose entries may
        be None), "embed": [B, N, D]}`` added to each block's post-softmax
        attention and to the patch embedding.  ``token_indices``: optional
        patch-token indices (0-based, CLS excluded) to keep after the
        positional embedding, the functional form of TIS's token dropping:
        ``[K]``, one set for the whole batch, or ``[B, K]``, one set a row
        (xai_tpu vmaps its ``[K]`` form over the rows); CLS is always
        kept."""
        b = x.shape[0]
        # NCHW conv, then [B, D, gh, gw] -> [B, gh*gw, D]: the row-major
        # token order of xai_tpu's NHWC reshape
        y = self.patch_embed(x).flatten(2).transpose(1, 2)
        y = torch.cat([self.cls_token.expand(b, -1, -1), y], dim=1)
        y = y + self.pos_embed
        if probes is not None and "embed" in probes:
            y = y + probes["embed"]
        patch_embedding = y
        if token_indices is not None:
            if token_indices.dim() == 1:
                kept = y[:, 1:][:, token_indices]
            else:
                kept = torch.gather(y[:, 1:], 1, token_indices[..., None]
                                    .expand(-1, -1, y.shape[-1]))
            y = torch.cat([y[:, :1], kept], dim=1)
        tap_list = []
        attn_probes = probes.get("attn") if probes is not None else None
        for i, block in enumerate(self.blocks()):
            y, tap = block(y, None if attn_probes is None
                           else attn_probes[i])
            if taps:
                # kept only when asked for: a block's intermediates are
                # ~8 MB an image at ViT-B/16, and a B=4 battery's
                # 180-image forwards would hold all twelve blocks' (~17 GB)
                tap_list.append(tap)
        logits = self.head(self.norm(y)[:, 0])
        if not taps:
            return logits
        stacked = {k: torch.stack([t[k] for t in tap_list])
                   for k in tap_list[0]}
        stacked["patch_embedding"] = patch_embedding
        return logits, stacked


def zero_probes(cfg: ViTConfig, batch: int = 1, dtype=torch.float32,
                device=None) -> dict:
    return {
        "attn": torch.zeros((cfg.depth, batch, cfg.num_heads, cfg.tokens,
                             cfg.tokens), dtype=dtype, device=device),
        "embed": torch.zeros((batch, cfg.tokens, cfg.embed_dim), dtype=dtype,
                             device=device),
    }


def block_probs(model: VisionTransformer, block_outs: torch.Tensor,
                softmax: bool = True) -> torch.Tensor:
    """The final norm and head applied to every block output's CLS token:
    the reference's per-block classification probabilities.  block_outs:
    ``[L, B, N, D]`` stacked tap -> ``[L, B, num_classes]`` float32.  The
    norm is the two-pass formula, written out as xai_tpu writes it."""
    mu = block_outs.mean(-1, keepdim=True)
    var = ((block_outs - mu) ** 2).mean(-1, keepdim=True)
    y = (block_outs - mu) * torch.rsqrt(var + 1e-6)
    y = y * model.norm.scale + model.norm.bias
    # float32 products and sums (xai_tpu: preferred_element_type=f32)
    logits = y[:, :, 0].float() @ model.head.weight.float().T
    logits = logits + model.head.bias.float()
    return torch.softmax(logits, dim=-1) if softmax else logits


def make_model(arch: str, num_classes: int = 1000) -> VisionTransformer:
    cfg = CONFIGS[arch]
    if num_classes != cfg.num_classes:
        cfg = dataclasses.replace(cfg, num_classes=num_classes)
    return VisionTransformer(cfg)


@torch.no_grad()
def init_random(model: VisionTransformer, seed: int = 0) -> nn.Module:
    """Seeded random weights in flax's default scheme: LeCun-normal kernels
    and zero biases (``lecun_init_``), a zero ``cls_token``, ``pos_embed``
    from normal(0, 0.02), LayerNorm scale 1 and bias 0.  The numbers
    differ from JAX's PRNG; tests that compare the two packages carry the
    JAX weights over instead."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    lecun_init_(model, gen)
    model.cls_token.zero_()
    model.pos_embed.copy_(torch.randn(model.pos_embed.shape, generator=gen)
                          * 0.02)
    for m in model.modules():
        if isinstance(m, LayerNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()
    return model


def make_bundle(arch_or_cli: str, state: Optional[dict] = None,
                seed: int = 0, batch_size: int = 25,
                device=None) -> ModelBundle:
    """The bundle of a timm arch or CLI name: seeded random weights
    (:func:`init_random`), or ``state`` (a state dict, e.g. from
    ``convert/from_jax.py load_params``), on ``device``."""
    model = init_random(make_model(CLI_ARCH.get(arch_or_cli, arch_or_cli)),
                        seed)
    if state is not None:
        model.load_state_dict(state)
    cfg = model.cfg
    meta = ModelMeta(name=arch_or_cli, family="vit", img_hw=cfg.img_hw,
                     num_classes=cfg.num_classes, num_patches=cfg.grid,
                     batch_size=batch_size, mean=VIT_MEAN, std=VIT_STD)
    return ModelBundle(meta, model.to(device))
