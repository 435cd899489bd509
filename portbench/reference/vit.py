"""Plain Vision Transformer forward (Dosovitskiy et al. 2021; timm's
``vit_base_patch16_224``: pre-norm blocks, LayerNorm eps 1e-6, exact
GELU, CLS token read by the head).

Float32, plain ``torch`` operations over a dict of weights keyed by the
names of the program's state dict.  The attention is written out, and
:func:`forward` can return every block's head-mean attention map for the
rollout.  Imports nothing of the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def tokens(cfg: dict) -> int:
    return (cfg["img_hw"] // cfg["patch"]) ** 2 + 1


def param_spec(cfg: dict) -> list:
    """``[(name, shape, kind)]`` of every weight; ``kind`` names the
    benchmark's init rule (``portbench/weights.py``)."""
    d, p, m = cfg["hidden_size"], cfg["patch"], cfg["mlp_size"]
    spec = [("patch_embed.weight", (d, 3, p, p), "linear"),
            ("patch_embed.bias", (d,), "zero"),
            ("cls_token", (1, 1, d), "zero"),
            ("pos_embed", (1, tokens(cfg), d), "embed")]
    for i in range(cfg["num_hidden_layers"]):
        b = f"block{i}."
        spec += [(b + "norm1.scale", (d,), "one"),
                 (b + "norm1.bias", (d,), "zero"),
                 (b + "attn.qkv.weight", (3 * d, d), "linear"),
                 (b + "attn.qkv.bias", (3 * d,), "zero"),
                 (b + "attn.proj.weight", (d, d), "linear"),
                 (b + "attn.proj.bias", (d,), "zero"),
                 (b + "norm2.scale", (d,), "one"),
                 (b + "norm2.bias", (d,), "zero"),
                 (b + "mlp_fc1.weight", (m, d), "linear"),
                 (b + "mlp_fc1.bias", (m,), "zero"),
                 (b + "mlp_fc2.weight", (d, m), "linear"),
                 (b + "mlp_fc2.bias", (d,), "zero")]
    spec += [("norm.scale", (d,), "one"), ("norm.bias", (d,), "zero"),
             ("head.weight", (cfg["num_classes"], d), "head"),
             ("head.bias", (cfg["num_classes"],), "zero")]
    return spec


def _ln(w, name, x, eps=1e-6):
    return F.layer_norm(x, x.shape[-1:], w[name + ".scale"],
                        w[name + ".bias"], eps)


def _lin(w, name, x):
    return x @ w[name + ".weight"].T + w[name + ".bias"]


def forward(w: dict, cfg: dict, x: torch.Tensor, attn_maps: bool = False):
    """``[N, 3, H, W]`` -> logits ``[N, classes]``; with ``attn_maps``
    also every block's attention averaged over heads, ``[L, N, T, T]``."""
    n = x.shape[0]
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    y = F.conv2d(x, w["patch_embed.weight"], w["patch_embed.bias"],
                 stride=cfg["patch"]).flatten(2).transpose(1, 2)
    y = torch.cat([w["cls_token"].expand(n, -1, -1), y], 1) + w["pos_embed"]
    t = y.shape[1]
    maps = []
    for i in range(cfg["num_hidden_layers"]):
        b = f"block{i}."
        qkv = _lin(w, b + "attn.qkv", _ln(w, b + "norm1", y))
        q, k, v = qkv.view(n, t, 3, h, d // h).permute(2, 0, 3, 1, 4)
        attn = torch.softmax((q @ k.transpose(-2, -1)) * (d // h) ** -0.5,
                             dim=-1)
        if attn_maps:
            maps.append(attn.mean(1))
        a = (attn @ v).transpose(1, 2).reshape(n, t, d)
        y = y + _lin(w, b + "attn.proj", a)
        y = y + _lin(w, b + "mlp_fc2",
                     F.gelu(_lin(w, b + "mlp_fc1", _ln(w, b + "norm2", y))))
    logits = _lin(w, "head", _ln(w, "norm", y)[:, 0])
    if attn_maps:
        return logits, torch.stack(maps)
    return logits


def macs(cfg: dict) -> int:
    """Multiply-accumulates of one forward: the patch embedding, per block
    the q/k/v, attention logits, attention times values, projection and
    the two MLP products, and the head on the CLS token."""
    d, m, t = cfg["hidden_size"], cfg["mlp_size"], tokens(cfg)
    p = cfg["patch"]
    block = t * 3 * d * d + 2 * t * t * d + t * d * d + 2 * t * d * m
    return ((t - 1) * d * 3 * p * p + cfg["num_hidden_layers"] * block
            + cfg["num_classes"] * d)
