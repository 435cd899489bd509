"""Plain Swin Transformer forward (Liu et al. 2021, arXiv:2103.14030;
timm's ``swin_base_patch4_window7_224``, torchvision's ``swin_b``): a
``patch_size`` x ``patch_size`` patch embedding with its LayerNorm;
stages of pre-norm blocks whose attention runs within ``window_size`` x
``window_size`` windows with a learned relative position bias, every
second block's windows shifted by half a window under the shifted-window
mask; patch merging between stages; LayerNorm (eps 1e-5), exact GELU, and
a head on the mean of the last stage's tokens.

As the paper and timm compute it: q scaled by head_dim ** -0.5 before
``q @ k^T``, then the relative bias, then -100 between tokens of
different regions of the shifted grid, then the softmax.  (The program
scales the product instead, which changes only the rounding.)  A window
larger than its stage's grid shrinks to the grid, and its shift is then
dropped (timm's rule; Swin-B's last stage at 224 px).

Float32, plain ``torch`` operations over a dict of weights keyed by the
names of the program's state dict.  Imports nothing of the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-5


def stages(cfg: dict):
    """``(stage, depth, heads, width, grid side, window)`` of every
    stage."""
    assert cfg["img_hw"] % cfg["patch_size"] == 0
    dim, res = cfg["embed_dim"], cfg["img_hw"] // cfg["patch_size"]
    for s, (depth, heads) in enumerate(zip(cfg["depths"],
                                           cfg["num_heads"])):
        if s > 0:
            dim, res = 2 * dim, res // 2
        yield s, depth, heads, dim, res, min(cfg["window_size"], res)


def shift_of(cfg: dict, block: int, res: int, ws: int) -> int:
    """The shift of a stage's block: half a window on every second block,
    none where the window covers the grid."""
    return 0 if block % 2 == 0 or ws >= res else cfg["window_size"] // 2


def param_spec(cfg: dict) -> list:
    """``[(name, shape, kind)]`` of every weight; ``kind`` names the
    benchmark's init rule (``portbench/weights.py``).  Every bias but the
    head's is a ``shift``, as a trained model's are nonzero: with zero
    biases the zero image (IG's first row) leaves every activation 0,
    each LayerNorm's Jacobian is then 1 / sqrt(eps) (316), and the input
    gradient overflows float32 through Swin-B's LayerNorms in series."""
    c, p = cfg["embed_dim"], cfg["patch_size"]
    spec = [("patch_embed.weight", (c, 3, p, p), "linear"),
            ("patch_embed.bias", (c,), "shift"),
            ("patch_norm.scale", (c,), "one"),
            ("patch_norm.bias", (c,), "shift")]
    for s, depth, heads, d, res, ws in stages(cfg):
        if s > 0:
            m = f"merge{s}."
            spec += [(m + "norm.scale", (2 * d,), "one"),
                     (m + "norm.bias", (2 * d,), "shift"),
                     (m + "reduction.weight", (d, 2 * d), "linear")]
        hidden = int(cfg["mlp_ratio"] * d)
        for b in range(depth):
            k = f"stage{s}_block{b}."
            spec += [(k + "norm1.scale", (d,), "one"),
                     (k + "norm1.bias", (d,), "shift"),
                     (k + "attn.rel_bias_table", ((2 * ws - 1) ** 2, heads),
                      "embed"),
                     (k + "attn.qkv.weight", (3 * d, d), "linear"),
                     (k + "attn.qkv.bias", (3 * d,), "shift"),
                     (k + "attn.proj.weight", (d, d), "linear"),
                     (k + "attn.proj.bias", (d,), "shift"),
                     (k + "norm2.scale", (d,), "one"),
                     (k + "norm2.bias", (d,), "shift"),
                     (k + "mlp_fc1.weight", (hidden, d), "linear"),
                     (k + "mlp_fc1.bias", (hidden,), "shift"),
                     (k + "mlp_fc2.weight", (d, hidden), "linear"),
                     (k + "mlp_fc2.bias", (d,), "shift")]
    d = cfg["embed_dim"] * 2 ** (len(cfg["depths"]) - 1)
    spec += [("norm.scale", (d,), "one"), ("norm.bias", (d,), "shift"),
             ("head.weight", (cfg["num_classes"], d), "head"),
             ("head.bias", (cfg["num_classes"],), "zero")]
    return spec


def _ln(w, name, x):
    return F.layer_norm(x, x.shape[-1:], w[name + ".scale"],
                        w[name + ".bias"], EPS)


def _lin(w, name, x):
    y = x @ w[name + ".weight"].T
    return y + w[name + ".bias"] if name + ".bias" in w else y


def _windows(x, ws):
    """``[B, H, W, C]`` -> ``[B * H/ws * W/ws, ws*ws, C]``."""
    b, h, wd, c = x.shape
    x = x.view(b, h // ws, ws, wd // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def _unwindows(x, ws, b, h, wd):
    c = x.shape[-1]
    x = x.view(b, h // ws, wd // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, wd, c)


def relative_index(ws: int, device) -> torch.Tensor:
    """``[ws*ws, ws*ws]`` row of the bias table of each (query, key)
    pair: their offset, each axis shifted to ``0 .. 2 ws - 2``."""
    ij = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                    indexing="ij")).flatten(1)
    rel = (ij[:, :, None] - ij[:, None, :]) + (ws - 1)
    return (rel[0] * (2 * ws - 1) + rel[1]).to(device)


def shift_mask(res: int, ws: int, shift: int, device) -> torch.Tensor:
    """``[nW, ws*ws, ws*ws]``: -100 between tokens of different regions
    of the grid rolled by ``-shift``, 0 within one."""
    region = torch.zeros(1, res, res, 1)
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for i, (hs, wss) in enumerate((h, w) for h in cuts for w in cuts):
        region[:, hs, wss] = i
    r = _windows(region, ws)[..., 0]
    return torch.where(r[:, None, :] != r[:, :, None], -100.0, 0.0).to(
        device)


def _attention(w, name, x, heads, ws, mask):
    """Windowed attention of ``[B', N, C]`` windows."""
    nw, n, c = x.shape
    hd = c // heads
    q, k, v = _lin(w, name + ".qkv", x).view(nw, n, 3, heads, hd) \
        .permute(2, 0, 3, 1, 4)
    attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
    bias = w[name + ".rel_bias_table"][relative_index(ws, x.device)]
    attn = attn + bias.permute(2, 0, 1)[None]
    if mask is not None:
        attn = (attn.view(-1, mask.shape[0], heads, n, n)
                + mask[None, :, None]).view(nw, heads, n, n)
    out = (torch.softmax(attn, -1) @ v).transpose(1, 2).reshape(nw, n, c)
    return _lin(w, name + ".proj", out)


def _block(w, k, y, heads, ws, shift):
    b, h, wd, _ = y.shape
    a = _ln(w, k + "norm1", y)
    if shift:
        a = torch.roll(a, (-shift, -shift), dims=(1, 2))
    mask = shift_mask(h, ws, shift, y.device) if shift else None
    a = _unwindows(_attention(w, k + "attn", _windows(a, ws), heads, ws,
                              mask), ws, b, h, wd)
    if shift:
        a = torch.roll(a, (shift, shift), dims=(1, 2))
    y = y + a
    return y + _lin(w, k + "mlp_fc2",
                    F.gelu(_lin(w, k + "mlp_fc1", _ln(w, k + "norm2", y))))


def forward(w: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """``[N, 3, H, W]`` -> logits ``[N, classes]``."""
    y = F.conv2d(x, w["patch_embed.weight"], w["patch_embed.bias"],
                 stride=cfg["patch_size"]).permute(0, 2, 3, 1)
    y = _ln(w, "patch_norm", y)
    for s, depth, heads, d, res, ws in stages(cfg):
        if s > 0:
            y = torch.cat([y[:, 0::2, 0::2], y[:, 1::2, 0::2],
                           y[:, 0::2, 1::2], y[:, 1::2, 1::2]], -1)
            y = _lin(w, f"merge{s}.reduction", _ln(w, f"merge{s}.norm", y))
        for b in range(depth):
            y = _block(w, f"stage{s}_block{b}.", y, heads, ws,
                       shift_of(cfg, b, res, ws))
    return _lin(w, "head", _ln(w, "norm", y).mean(dim=(1, 2)))


def macs(cfg: dict) -> int:
    """Multiply-accumulates of one forward: the patch embedding; per
    block q/k/v, the attention logits and the attention times values
    (each token against its window's), the projection and the two MLP
    products; each patch merging's reduction; the head."""
    p = cfg["patch_size"]
    res0 = cfg["img_hw"] // p
    total = res0 * res0 * cfg["embed_dim"] * 3 * p * p
    for s, depth, heads, d, res, ws in stages(cfg):
        t = res * res
        if s > 0:
            total += t * 2 * d * d                       # 4 (d/2) -> d
        hidden = int(cfg["mlp_ratio"] * d)
        total += depth * (t * 4 * d * d + 2 * t * ws * ws * d
                          + 2 * t * d * hidden)
    return total + cfg["num_classes"] * d
