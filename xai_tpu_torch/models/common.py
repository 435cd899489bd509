"""The model interface every attribution method and metric builds on.

Counterpart of ``xai_tpu/models/common.py``.  A bundle wraps an
``nn.Module`` whose parameters are frozen (``requires_grad=False``): every
gradient the methods take is with respect to the input only, as the JAX
VJP is, so a backward pass never computes weight gradients.

All bundle functions take NCHW batches; the public methods and metrics
transpose from ``[H, W, C]`` once at their boundary.
"""
from __future__ import annotations

import copy
import dataclasses
import itertools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.layernorm import fits, layernorm, layernorm_plain
from ..ops.preprocess import IMAGENET_MEAN, IMAGENET_STD
from ..utils import trace


@dataclasses.dataclass(frozen=True)
class ModelMeta:
    """Static metadata describing a model family member."""

    name: str                       # registry name, e.g. "R101", "VIT16"
    family: str                     # "cnn" | "vit" | "clip"
    img_hw: int = 224
    num_classes: int = 1000
    num_patches: int = 0            # per side: 14 for ViT-B/16, 7 for /32
    batch_size: int = 50            # reference's per-model chunk size
    # the normalization of the model's input (AGI composes it into the
    # model): ImageNet's for the CNNs, (0.5, 0.5, 0.5) for the ViTs
    mean: tuple = IMAGENET_MEAN
    std: tuple = IMAGENET_STD


class ModelBundle:
    """A model as a frozen module plus its metadata.

    ``apply`` maps an NCHW batch to logits; ``apply_taps`` also returns the
    dict of taps (stage activations, resnet.py; stacked per-block
    intermediates, vit.py); ``apply_probed`` adds zero probes to them.
    Each entry that runs the module adds its rows to the counter
    ``model_rows`` (``utils/trace.py``); a method that runs the module
    itself from its input adds them where it does."""

    def __init__(self, meta: ModelMeta, module: nn.Module):
        self.meta = meta
        self.module = module.eval().requires_grad_(False)
        self._casts = {}
        self._replicas = {}
        self._guided = None

    def _first_tensor(self):
        return next(itertools.chain(self.module.parameters(),
                                    self.module.buffers()), None)

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the module computes in: its first parameter's (or
        buffer's), float32 for a module that holds neither."""
        p = self._first_tensor()
        return torch.float32 if p is None else p.dtype

    @property
    def extras(self):
        """The family's static configuration (a ViT's ``ViTConfig``), as
        xai_tpu's ``bundle.extras`` holds it; None for the CNNs (CLIP:
        ``models/clip.py CLIPBundle``)."""
        return getattr(self.module, "cfg", None)

    @property
    def device(self) -> torch.device:
        p = self._first_tensor()
        return torch.device("cpu") if p is None else p.device

    def cast(self, dtype) -> "ModelBundle":
        """The bundle with its module in ``dtype`` (``None``: this one).
        The copy is made once per dtype and kept on the bundle; the float32
        module is never cast in place — the counterpart of xai_tpu's
        ``_cast_params_cached``."""
        if dtype is None or dtype == self.dtype:
            return self
        if dtype not in self._casts:
            self._casts[dtype] = self.with_module(
                copy.deepcopy(self.module).to(dtype))
        return self._casts[dtype]

    def to(self, device) -> "ModelBundle":
        """The bundle on ``device``: this one where it already is, else a
        copy of its module there (a mesh's replica), made once per device
        and kept on the bundle, as :meth:`cast`'s copies are."""
        device = torch.device(device)
        if device == self.device:
            return self
        if device not in self._replicas:
            self._replicas[device] = self._copy_to(device)
        return self._replicas[device]

    def _copy_to(self, device: torch.device) -> "ModelBundle":
        return self.with_module(copy.deepcopy(self.module).to(device))

    def with_module(self, module: nn.Module) -> "ModelBundle":
        """A bundle of this one's kind and metadata around ``module`` (a
        cast or randomized copy of this one's)."""
        return ModelBundle(self.meta, module)

    def guided(self) -> "ModelBundle":
        """The bundle with every ReLU under guided backprop's rule
        (``methods/guided.py guided_relu``), made once and kept on the
        bundle: the counterpart of xai_tpu's ``_guided_apply_cached``."""
        if self._guided is None:
            from ..methods.guided import guided_relu
            from .resnet import set_relu
            self._guided = ModelBundle(
                self.meta, set_relu(copy.deepcopy(self.module), guided_relu))
        return self._guided

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        trace.count("model_rows", x.shape[0])
        return self.module(x)

    # xai_tpu's bundle has both apply(params, x) and logits(x); with the
    # params inside the module they are one function
    logits = apply

    def apply_taps(self, x: torch.Tensor):
        trace.count("model_rows", x.shape[0])
        return self.module(x, taps=True)

    def apply_tokens(self, x: torch.Tensor, token_indices: torch.Tensor):
        """ViT only: logits with only CLS and the ``token_indices`` patch
        tokens kept after the positional embedding (``[K]`` for the batch,
        or ``[B, K]`` a row)."""
        trace.count("model_rows", x.shape[0])
        return self.module(x, token_indices=token_indices)

    def apply_probed(self, x: torch.Tensor, probes: dict):
        """(logits, taps) with ``probes[name]`` added to the tap ``name``:
        the gradient with respect to a zero probe is the gradient with
        respect to that activation."""
        trace.count("model_rows", x.shape[0])
        return self.module(x, taps=True, probes=probes)

    @torch.inference_mode()
    def probs(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.apply(x), dim=-1)

    def predict(self, x: torch.Tensor):
        """(class, softmax prob) of the top-1 class for one image
        ``[1, C, H, W]`` — the reference's ``get_classifier_pred``."""
        pr = self.probs(x)[0]
        cls = int(torch.argmax(pr))
        return cls, float(pr[cls])

    def score_and_grad(self, x: torch.Tensor, target):
        """Batched d logit[target] / d input — the reference's
        ``getGradientsParallel``.  ``target`` is one class for every row,
        or an int64 ``[N]`` tensor of one class per row.  One batched
        forward and one backward: each score depends only on its own
        image, so the gradient of the sum is the per-sample gradient.
        Scores are taken from float32 logits and the gradient comes back
        float32 whatever the module's dtype, as xai_tpu's ``_flat_grads``
        does.  The backward is one ``backward`` part (``utils/trace.py``):
        it runs on autograd's thread, outside the forward's parts.
        Returns (grads, scores)."""
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            scores = target_scores(self.apply(x).float(), target)
            with trace.part("backward", x):
                (g,) = torch.autograd.grad(scores.sum(), x)
        return g.float(), scores.detach()


def target_scores(logits: torch.Tensor, target) -> torch.Tensor:
    """``[N, classes]`` -> ``[N]``: each row's entry at ``target``, one
    class or an int64 ``[N]`` tensor of one class per row (xai_tpu's
    ``take_along_axis``)."""
    if isinstance(target, torch.Tensor):
        return logits.gather(1, target.view(-1, 1))[:, 0]
    return logits[:, target]


@torch.no_grad()
def lecun_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax's default kernels on every ``Conv2d`` and ``Linear`` of
    ``model``, in module order, drawn from the CPU ``generator``:
    ``lecun_normal`` (a normal truncated at +-2 sd, rescaled to unit
    variance, times 1/sqrt(fan_in)) and zero biases."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            m.weight.copy_(w * std)
            if m.bias is not None:
                m.bias.zero_()
    return model


def same_pads(size: int, kernel: int, stride: int) -> tuple:
    """XLA's ``"SAME"`` padding of one spatial axis: the output has
    ceil(size / stride) positions and the total padding they need is split
    low = total // 2, high = total - low."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Conv2d):
    """``nn.Conv2d`` with flax's default padding, XLA's ``"SAME"``
    (:func:`same_pads`), at any stride: torch's ``padding="same"`` refuses
    a stride above 1.  A kernel that divides the input at its own stride
    pads nothing."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 bias: bool = True):
        super().__init__(cin, cout, kernel, stride=stride, padding=0,
                         bias=bias)

    def forward(self, x):
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        top, bottom = same_pads(x.shape[-2], kh, sh)
        left, right = same_pads(x.shape[-1], kw, sw)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return self._conv_forward(x, self.weight, self.bias)


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on an ``[B, H, W, C]`` batch, returned ``[B, H', W', C']``:
    the NCHW view of a channels-last tensor, which cuDNN convolves in
    place of a layout copy.  A ``conv`` part (``utils/trace.py``)."""
    with trace.part("conv", x):
        return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def linear(fc: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``fc(x)`` as a ``linear`` part (``utils/trace.py``)."""
    with trace.part("linear", x):
        return fc(x)


def mlp(fc1: nn.Module, fc2: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``fc2(gelu(fc1(x)))``, exact GELU, as a ``linear``, a
    ``pointwise`` and a ``linear`` part."""
    h = linear(fc1, x)
    with trace.part("pointwise", h):
        h = F.gelu(h)
    return linear(fc2, h)


class FoldedBN(nn.Module):
    """Inference BatchNorm as y = x * scale + bias, per channel: axis 1
    (NCHW) or, with ``channels_last``, the last axis (NHWC); a ``norm``
    part."""

    def __init__(self, features: int, channels_last: bool = False):
        super().__init__()
        self.channels_last = channels_last
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        with trace.part("norm", x):
            if self.channels_last:
                return x * self.scale + self.bias
            return x * self.scale[:, None, None] + self.bias[:, None, None]


def _fused_layernorm(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor) -> bool:
    """Whether a LayerNorm call takes the fused kernel: no autograd graph
    is recorded (the kernel has no backward), and the kernel takes the
    operands (:func:`kernels.layernorm.fits`: a contiguous CUDA float32
    ``x`` of a width it covers, float32 scale and bias)."""
    return not torch.is_grad_enabled() and fits(x, scale, bias)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm(epsilon=eps)`` over the last axis as flax
    computes it: float32 statistics with the fast variance max(0, E[x^2] -
    E[x]^2), then ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in
    float32, cast back to the compute dtype.  Where
    :func:`_fused_layernorm` holds, one pass of ``kernels/layernorm.py``,
    which differs from the separate ops only by the order of its two
    sums; else the separate ops.  Counts its token rows in
    ``layernorm_rows``, and those of the fused calls in
    ``layernorm_fused_rows``; a ``norm`` part either way."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        rows = math.prod(x.shape[:-1])
        trace.count("layernorm_rows", rows)
        with trace.part("norm", x):
            if _fused_layernorm(x, self.scale, self.bias):
                trace.count("layernorm_fused_rows", rows)
                return layernorm(x, self.scale, self.bias, self.eps)
            return layernorm_plain(x, self.scale, self.bias, self.eps)


@torch.no_grad()
def init_flax_default(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights in flax's default scheme for the zoo's
    families, drawn from one CPU generator in module order: LeCun-normal
    kernels and zero biases (:func:`lecun_init_`), then every
    ``rel_bias_table`` and ``pos_embed*`` from normal(0, 0.02), a zero
    ``cls_token``, ConvNeXt's layer scale ``gamma`` at flax's 1e-6,
    LayerNorm and FoldedBN scale 1 and bias 0.  The numbers
    differ from JAX's PRNG; tests that compare the two packages carry the
    JAX weights over instead."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    lecun_init_(model, gen)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "rel_bias_table" or leaf.startswith("pos_embed"):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        elif leaf == "cls_token":
            p.zero_()
        elif leaf == "gamma":
            p.fill_(1e-6)
    for m in model.modules():
        if isinstance(m, (LayerNorm, FoldedBN)):
            m.scale.fill_(1.0)
            m.bias.zero_()
    return model
