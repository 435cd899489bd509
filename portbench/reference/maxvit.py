"""Plain MaxViT forward (Tu et al. 2022, arXiv:2204.01697), in the form of
torchvision's ``maxvit_t``: a stem of a stride-2 3x3 convolution, BN and
GELU, then a 3x3 convolution; stages of blocks, each an MBConv, then
block attention within ``partition`` x ``partition`` windows, then grid
attention over a ``partition`` x ``partition`` grid of tokens that lie
H / ``partition`` apart; a stage's first block halves the side; the head
mean-pools, normalizes, applies a tanh ``head_pre`` and a bias-free
classifier.

MBConv: BN pre-norm; 1x1 expansion to ``expansion`` x width, BN, GELU;
3x3 depthwise (the block's stride), BN, GELU; squeeze-excite (mean pool,
a linear to ``squeeze_ratio`` x width and SiLU, a linear back and a
sigmoid, the rescale); a 1x1 projection with bias; the shortcut, where
the stride or the width changes, a 1x1 convolution with bias, after a
3x3 average pool of stride 2 where the stride is 2.  Each attention
layer is pre-norm (LayerNorm, eps 1e-5), multi-head attention of
``head_dim`` heads with a learned relative position bias, its
projection, the skip; then a pre-norm MLP of ``mlp_ratio`` x width with
exact GELU, the skip.

Departures from the paper, all torchvision's:
- the attention logits are scaled by the layer's width ** -0.5
  (torchvision's ``feat_dim ** -0.5``), not by head_dim ** -0.5;
- the stride-2 shortcut pools 3x3 windows with padding 1, the padding
  counted in the mean (``AvgPool2d(3, 2, 1)``), where the paper pools
  2x2;
- BatchNorm is folded at inference into a scale and a shift a channel;
- the squeeze-excite squeezes to the block's output width (x 0.25), and
  the head has the tanh ``head_pre`` and no classifier bias.

Windows shrink to the stage's grid where it is smaller (a 32 px test
model's last stage).  Float32, plain ``torch`` operations over a dict of
weights keyed by the names of the program's state dict.  Imports nothing
of the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .swin import _lin, _ln, _unwindows, _windows, relative_index


def blocks(cfg: dict):
    """``(stage, block, cin, width, heads, stride, side in, side out,
    window)`` of every block, from the stem's output on."""
    res = -(-cfg["img_hw"] // 2)
    cin = cfg["stem_dim"]
    for s, (depth, dim) in enumerate(zip(cfg["depths"], cfg["dims"])):
        for b in range(depth):
            stride = 2 if b == 0 else 1
            out = -(-res // stride)
            yield (s, b, cin, dim, dim // cfg["head_dim"], stride, res, out,
                   min(cfg["partition"], out))
            cin, res = dim, out


def squeeze(cfg: dict, width: int) -> int:
    """The squeeze-excite's inner width: torchvision's
    ``int(width * squeeze_ratio)``, of the block's output width."""
    return int(width * cfg["squeeze_ratio"])


def param_spec(cfg: dict) -> list:
    """``[(name, shape, kind)]`` of every weight; ``kind`` names the
    benchmark's init rule (``portbench/weights.py``).  Every bias but the
    (absent) classifier's is a ``shift`` and every BN scale is 1: with
    zero biases the zero image (IG's first row) leaves every activation 0
    and the input gradient overflows through the LayerNorms in series,
    as in a Swin (``reference/swin.py``)."""
    c = cfg["stem_dim"]
    spec = [("stem_conv1.weight", (c, 3, 3, 3), "conv"),
            ("stem_bn.scale", (c,), "one"), ("stem_bn.bias", (c,), "shift"),
            ("stem_conv2.weight", (c, c, 3, 3), "conv"),
            ("stem_conv2.bias", (c,), "shift")]
    for s, b, cin, d, heads, stride, _, _, ws in blocks(cfg):
        mid, sqz = cfg["expansion"] * d, squeeze(cfg, d)
        k = f"stage{s}_block{b}.mbconv."
        spec += [(k + "pre_norm.scale", (cin,), "one"),
                 (k + "pre_norm.bias", (cin,), "shift"),
                 (k + "conv_a.weight", (mid, cin, 1, 1), "conv"),
                 (k + "bn_a.scale", (mid,), "one"),
                 (k + "bn_a.bias", (mid,), "shift"),
                 (k + "conv_b.weight", (mid, 1, 3, 3), "conv"),
                 (k + "bn_b.scale", (mid,), "one"),
                 (k + "bn_b.bias", (mid,), "shift"),
                 (k + "se.fc1.weight", (sqz, mid), "linear"),
                 (k + "se.fc1.bias", (sqz,), "shift"),
                 (k + "se.fc2.weight", (mid, sqz), "linear"),
                 (k + "se.fc2.bias", (mid,), "shift"),
                 (k + "conv_c.weight", (d, mid, 1, 1), "conv"),
                 (k + "conv_c.bias", (d,), "shift")]
        if stride != 1 or cin != d:
            spec += [(k + "shortcut.weight", (d, cin, 1, 1), "conv"),
                     (k + "shortcut.bias", (d,), "shift")]
        hidden = int(cfg["mlp_ratio"] * d)
        for layer in ("window_attn", "grid_attn"):
            k = f"stage{s}_block{b}.{layer}."
            spec += [(k + "norm.scale", (d,), "one"),
                     (k + "norm.bias", (d,), "shift"),
                     (k + "attn.rel_bias_table", ((2 * ws - 1) ** 2, heads),
                      "embed"),
                     (k + "attn.qkv.weight", (3 * d, d), "linear"),
                     (k + "attn.qkv.bias", (3 * d,), "shift"),
                     (k + "attn.proj.weight", (d, d), "linear"),
                     (k + "attn.proj.bias", (d,), "shift"),
                     (k + "mlp_norm.scale", (d,), "one"),
                     (k + "mlp_norm.bias", (d,), "shift"),
                     (k + "mlp_fc1.weight", (hidden, d), "linear"),
                     (k + "mlp_fc1.bias", (hidden,), "shift"),
                     (k + "mlp_fc2.weight", (d, hidden), "linear"),
                     (k + "mlp_fc2.bias", (d,), "shift")]
    d = cfg["dims"][-1]
    return spec + [("head_norm.scale", (d,), "one"),
                   ("head_norm.bias", (d,), "shift"),
                   ("head_pre.weight", (d, d), "linear"),
                   ("head_pre.bias", (d,), "shift"),
                   ("head.weight", (cfg["num_classes"], d), "head")]


def _bn(w, name, x):
    """Folded BatchNorm of ``[B, C, H, W]``."""
    return x * w[name + ".scale"][:, None, None] + \
        w[name + ".bias"][:, None, None]


def _conv(w, name, x, **kw):
    return F.conv2d(x, w[name + ".weight"], w.get(name + ".bias"), **kw)


def _mbconv(w, k, x, stride):
    """``[B, C, H, W]`` -> ``[B, width, H / stride, W / stride]``."""
    h = F.gelu(_bn(w, k + "bn_a", _conv(w, k + "conv_a",
                                        _bn(w, k + "pre_norm", x))))
    h = F.gelu(_bn(w, k + "bn_b", _conv(w, k + "conv_b", h, stride=stride,
                                        padding=1, groups=h.shape[1])))
    s = F.silu(_lin(w, k + "se.fc1", h.mean(dim=(2, 3))))
    h = h * torch.sigmoid(_lin(w, k + "se.fc2", s))[:, :, None, None]
    h = _conv(w, k + "conv_c", h)
    if k + "shortcut.weight" in w:
        if stride == 2:
            x = F.avg_pool2d(x, 3, 2, 1, count_include_pad=True)
        x = _conv(w, k + "shortcut", x)
    return x + h


def _grid(x, gs):
    """``[B, H, W, C]`` -> ``[B * (H/gs) * (W/gs), gs*gs, C]``: each group
    holds the ``gs`` x ``gs`` tokens that lie H/gs (W/gs) apart."""
    b, h, wd, c = x.shape
    x = x.view(b, gs, h // gs, gs, wd // gs, c).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(-1, gs * gs, c)


def _ungrid(x, gs, b, h, wd):
    c = x.shape[-1]
    x = x.view(b, h // gs, wd // gs, gs, gs, c).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, h, wd, c)


def _attention(w, name, x, heads, ws):
    """Relative-bias attention of ``[G, N, C]`` groups of tokens, scaled
    by C ** -0.5."""
    g, n, c = x.shape
    q, k, v = _lin(w, name + ".qkv", x).view(g, n, 3, heads, c // heads) \
        .permute(2, 0, 3, 1, 4)
    attn = (q * c ** -0.5) @ k.transpose(-2, -1)
    bias = w[name + ".rel_bias_table"][relative_index(ws, x.device)]
    attn = attn + bias.permute(2, 0, 1)[None]
    out = (torch.softmax(attn, -1) @ v).transpose(1, 2).reshape(g, n, c)
    return _lin(w, name + ".proj", out)


def _attn_layer(w, k, y, heads, ws, grid):
    """One pre-norm attention layer and its MLP on ``[B, H, W, C]``."""
    b, h, wd, _ = y.shape
    part, unpart = (_grid, _ungrid) if grid else (_windows, _unwindows)
    a = _attention(w, k + "attn", part(_ln(w, k + "norm", y), ws), heads, ws)
    y = y + unpart(a, ws, b, h, wd)
    return y + _lin(w, k + "mlp_fc2",
                    F.gelu(_lin(w, k + "mlp_fc1", _ln(w, k + "mlp_norm", y))))


def forward(w: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """``[N, 3, H, W]`` -> logits ``[N, classes]``."""
    y = F.gelu(_bn(w, "stem_bn", _conv(w, "stem_conv1", x, stride=2,
                                       padding=1)))
    y = _conv(w, "stem_conv2", y, padding=1)
    for s, b, _, _, heads, stride, _, _, ws in blocks(cfg):
        k = f"stage{s}_block{b}."
        y = _mbconv(w, k + "mbconv.", y, stride).permute(0, 2, 3, 1)
        y = _attn_layer(w, k + "window_attn.", y, heads, ws, grid=False)
        y = _attn_layer(w, k + "grid_attn.", y, heads, ws, grid=True)
        y = y.permute(0, 3, 1, 2)
    y = _ln(w, "head_norm", y.mean(dim=(2, 3)))
    return _lin(w, "head", torch.tanh(_lin(w, "head_pre", y)))


def macs(cfg: dict) -> int:
    """Multiply-accumulates of one forward: the stem's two convolutions;
    per block the expansion (at the block's input side), the depthwise
    3x3, the squeeze-excite's two linears, the projection and the
    shortcut's 1x1; per attention layer q/k/v, the logits and the
    attention times values (each token against its group's), the
    projection and the two MLP products; the head's two linears.  The
    poolings, norms and activations are not MACs."""
    side = -(-cfg["img_hw"] // 2)
    c = cfg["stem_dim"]
    total = side * side * c * 3 * 9 + side * side * c * c * 9
    for _, _, cin, d, _, stride, res, out, ws in blocks(cfg):
        mid, t = cfg["expansion"] * d, out * out
        hidden = int(cfg["mlp_ratio"] * d)
        total += (res * res * cin * mid + t * mid * 9
                  + 2 * mid * squeeze(cfg, d) + t * mid * d)
        if stride != 1 or cin != d:
            total += t * cin * d
        total += 2 * (4 * t * d * d + 2 * t * ws * ws * d
                      + 2 * t * d * hidden)
    d = cfg["dims"][-1]
    return total + d * d + cfg["num_classes"] * d
