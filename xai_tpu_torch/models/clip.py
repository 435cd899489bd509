"""CLIP (image and text towers) with a tap + probe API, as ``nn.Module``s.

Counterpart of ``xai_tpu/models/clip.py``, NCHW at the boundary: the
openai CLIP ViT with a visual tower (patch conv, class embedding,
``ln_pre``, pre-norm blocks with QuickGELU MLPs, ``ln_post``, projection
of every token) and a text tower (token embedding, causal blocks,
``ln_final``, projection at the EOT position, the ``argmax`` of the ids).
One model serves every CLIP explainer: attention maps and their gradients
come from taps and additive probes on the post-softmax attention, and the
dense decompositions of ``methods/clip_explain.py``,
``clip_surgery.py`` and ``clip_m2ib.py`` are functions of its weights.

Submodule and parameter names follow the JAX parameter tree
(``visual.conv1``, ``visual.class_embedding``,
``visual.positional_embedding``, ``visual.ln_pre``, ``visual.block{i}``
with ``ln_1``, ``attn.in_proj``, ``attn.out_proj``, ``ln_2``,
``mlp_c_fc``, ``mlp_c_proj``; ``visual.ln_post``, ``visual.proj``;
``text.token_embedding``, ``text.positional_embedding``,
``text.block{i}``, ``text.ln_final``, ``text.text_projection``;
``logit_scale``), so the weight carry of ``convert/from_jax.py`` is a
rename and a transpose of the ``kernel`` leaves; ``proj``,
``text_projection``, ``token_embedding`` and both positional embeddings
cross untransposed and are used as xai_tpu uses them (``y @ proj``,
``tok[ids]``).

Classification (evaluatePerturbation.py:68-74): 1000 normalized "a photo
of a {label}" text embeddings; the logits are ``image_embedding @ te.T /
0.1`` with the image embedding NOT normalized, as the reference and
xai_tpu compute them.  The text table stays float32 on a cast copy of the
bundle, as xai_tpu's ``apply`` closure keeps it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ..ops.preprocess import CLIP_MEAN, CLIP_STD
from .common import ModelBundle, ModelMeta, lecun_init_
from .vit import LayerNorm


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    patch: int = 16
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    embed_dim: int = 512
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    vocab_size: int = 49408
    context_length: int = 77
    img_hw: int = 224

    @property
    def tokens(self) -> int:
        return (self.img_hw // self.patch) ** 2 + 1

    @property
    def grid(self) -> int:
        return self.img_hw // self.patch


CONFIGS = {
    "clip_vit_b16": CLIPConfig(patch=16),
    "clip_vit_b32": CLIPConfig(patch=32),
}
CLI_ARCH = {"CLIP16": "clip_vit_b16", "CLIP32": "clip_vit_b32"}


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _stack_taps(tap_list):
    return {k: torch.stack([t[k] for t in tap_list]) for k in tap_list[0]}


class CLIPAttention(nn.Module):
    """Multi-head attention with a fused ``in_proj``: logits ``(q @ k^T)
    * hd^-0.5`` (scale after the product), the optional additive mask,
    softmax, the optional additive probe, ``@ v``, all in the compute
    dtype (the mask and the probe cast to it, as xai_tpu casts them)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj = nn.Linear(dim, 3 * dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, mask=None, probe=None):
        b, n, c = x.shape
        h = self.num_heads
        qkv = self.in_proj(x).view(b, n, 3, h, c // h)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        logits = (q @ k.transpose(-2, -1)) * (c // h) ** -0.5
        if mask is not None:
            logits = logits + mask.to(logits.dtype)
        attn = torch.softmax(logits, dim=-1)
        if probe is not None:
            attn = attn + probe.to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return self.out_proj(out), {"attn": attn, "q": q, "k": k, "v": v}


class CLIPBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.ln_1 = LayerNorm(dim, eps=1e-5)
        self.attn = CLIPAttention(dim, num_heads)
        self.ln_2 = LayerNorm(dim, eps=1e-5)
        self.mlp_c_fc = nn.Linear(dim, 4 * dim)
        self.mlp_c_proj = nn.Linear(4 * dim, dim)

    def forward(self, x, mask=None, probe=None):
        a, tap = self.attn(self.ln_1(x), mask, probe)
        x = x + a
        out = x + self.mlp_c_proj(quick_gelu(self.mlp_c_fc(self.ln_2(x))))
        tap["block_out"] = out
        return out, tap


def _run_blocks(blocks, y, probes, taps, mask=None):
    """Run ``blocks`` in order; ``probes``: optional ``{"attn": per-block
    probes}`` (a ``[L, B, H, N, N]`` tensor, or a list whose entries may
    be None).  Returns (y, the stacked taps or None)."""
    attn_probes = probes.get("attn") if probes is not None else None
    tap_list = []
    for i, block in enumerate(blocks):
        y, tap = block(y, mask, None if attn_probes is None
                       else attn_probes[i])
        if taps:
            # kept only when asked for, as in models/vit.py
            tap_list.append(tap)
    return y, (_stack_taps(tap_list) if taps else None)


class CLIPVisual(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.vision_width
        self.conv1 = nn.Conv2d(3, w, cfg.patch, stride=cfg.patch, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.tokens, w))
        self.ln_pre = LayerNorm(w, eps=1e-5)
        for i in range(cfg.vision_layers):
            setattr(self, f"block{i}", CLIPBlock(w, cfg.vision_heads))
        self.ln_post = LayerNorm(w, eps=1e-5)
        self.proj = nn.Parameter(torch.zeros(w, cfg.embed_dim))

    def blocks(self):
        return [getattr(self, f"block{i}")
                for i in range(self.cfg.vision_layers)]

    def embed(self, x):
        """``[B, 3, H, W]`` -> the ``ln_pre`` tokens ``[B, N, W]``, in
        xai_tpu's row-major (NHWC) token order."""
        b = x.shape[0]
        y = self.conv1(x).flatten(2).transpose(1, 2)
        y = torch.cat([self.class_embedding.expand(b, 1, -1), y], dim=1)
        return self.ln_pre(y + self.positional_embedding)

    def forward(self, x, probes=None, taps: bool = False,
                stop_before_last: bool = False):
        """Every token's projected embedding ``[B, N, E]`` (and the
        stacked taps); ``stop_before_last``: the input of the last block
        ``[B, N, W]`` instead."""
        blocks = self.blocks()
        if stop_before_last:
            blocks = blocks[:-1]
        y, tapped = _run_blocks(blocks, self.embed(x), probes, taps)
        if stop_before_last:
            return y
        emb = self.ln_post(y) @ self.proj
        return (emb, tapped) if taps else emb


class CLIPText(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.text_width
        self.token_embedding = nn.Parameter(torch.zeros(cfg.vocab_size, w))
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.context_length, w))
        for i in range(cfg.text_layers):
            setattr(self, f"block{i}", CLIPBlock(w, cfg.text_heads))
        self.ln_final = LayerNorm(w, eps=1e-5)
        self.text_projection = nn.Parameter(torch.zeros(w, cfg.embed_dim))

    def blocks(self):
        return [getattr(self, f"block{i}")
                for i in range(self.cfg.text_layers)]

    def forward(self, text, probes=None, taps: bool = False):
        """``[B, L]`` token ids -> the EOT token's projected embedding
        ``[B, E]`` (and the stacked taps)."""
        b, n = text.shape
        y = self.token_embedding[text] + self.positional_embedding[:n]
        mask = torch.full((n, n), float("-inf"), device=y.device).triu(1)
        y, tapped = _run_blocks(self.blocks(), y, probes, taps, mask)
        y = self.ln_final(y)
        eot = text.argmax(dim=-1)
        emb = y[torch.arange(b, device=y.device), eot] @ self.text_projection
        return (emb, tapped) if taps else emb


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.visual = CLIPVisual(cfg)
        self.text = CLIPText(cfg)
        self.logit_scale = nn.Parameter(torch.tensor(4.6052))

    def encode_image(self, x, probes=None, taps=False,
                     stop_before_last=False):
        return self.visual(x, probes=probes, taps=taps,
                           stop_before_last=stop_before_last)

    def encode_text(self, t, probes=None, taps=False):
        return self.text(t, probes=probes, taps=taps)

    def forward(self, x, t, vis_probes=None, txt_probes=None,
                taps: bool = False):
        """(logits_per_image, logits_per_text[, visual taps, text taps]):
        the scaled cosines of the CLS embeddings ``[B, 3, H, W]`` and the
        captions ``[T, L]``."""
        img, vtap = self.visual(x, probes=vis_probes, taps=True) if taps \
            else (self.visual(x, probes=vis_probes), None)
        txt, ttap = self.text(t, probes=txt_probes, taps=True) if taps \
            else (self.text(t, probes=txt_probes), None)
        img = img[:, 0]
        img_n = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
        txt_n = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
        lpi = self.logit_scale.exp() * img_n @ txt_n.T
        if taps:
            return lpi, lpi.T, vtap, ttap
        return lpi, lpi.T


def zero_probes(cfg: CLIPConfig, tower: str = "visual", batch: int = 1,
                seq: Optional[int] = None, dtype=torch.float32,
                device=None) -> dict:
    if tower == "visual":
        shape = (cfg.vision_layers, batch, cfg.vision_heads, cfg.tokens,
                 cfg.tokens)
    else:
        seq = seq or cfg.context_length
        shape = (cfg.text_layers, batch, cfg.text_heads, seq, seq)
    return {"attn": torch.zeros(shape, dtype=dtype, device=device)}


@torch.no_grad()
def init_random(model: CLIP, seed: int = 0) -> CLIP:
    """Seeded random weights in xai_tpu's (flax's) scheme: LeCun-normal
    conv and dense kernels, zero biases (``lecun_init_``), LayerNorm
    scale 1 and bias 0, normal(0, 0.02) class embedding, visual
    positional embedding, ``proj``, token embedding and
    ``text_projection``, normal(0, 0.01) text positional embedding,
    ``logit_scale`` 4.6052.  The numbers differ from JAX's PRNG; tests
    that compare the two packages carry the JAX weights over instead."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    lecun_init_(model, gen)
    for p, sd in ((model.visual.class_embedding, 0.02),
                  (model.visual.positional_embedding, 0.02),
                  (model.visual.proj, 0.02),
                  (model.text.token_embedding, 0.02),
                  (model.text.positional_embedding, 0.01),
                  (model.text.text_projection, 0.02)):
        p.copy_(torch.randn(p.shape, generator=gen) * sd)
    for m in model.modules():
        if isinstance(m, LayerNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()
    model.logit_scale.fill_(4.6052)
    return model


class CLIPBundle(ModelBundle):
    """A CLIP model with its class-prompt text table: ``apply`` maps an
    NCHW batch to ``encode_image[:, 0] @ te.T / 0.1``; ``apply_taps`` and
    ``apply_probed`` run the visual tower (every token's embedding and
    the stacked taps).  ``extras`` holds ``cfg``, ``text_embeddings``
    (``[classes, E]`` float32, normalized) and ``text_tokens_table``
    (``[classes, L]`` int64 ids, or None for a table made without
    prompts)."""

    def __init__(self, meta: ModelMeta, module: CLIP,
                 text_embeddings: torch.Tensor,
                 text_tokens: Optional[torch.Tensor] = None):
        super().__init__(meta, module)
        self.text_embeddings = text_embeddings
        self.text_tokens = text_tokens

    @property
    def extras(self):
        return {"cfg": self.module.cfg,
                "text_embeddings": self.text_embeddings,
                "text_tokens_table": self.text_tokens}

    def with_module(self, module: CLIP) -> "CLIPBundle":
        # the float32 text table goes with the module, whatever its dtype
        return CLIPBundle(self.meta, module, self.text_embeddings,
                          self.text_tokens)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        te = self.text_embeddings
        emb = self.module.encode_image(x)[:, 0]
        return emb.to(te.dtype) @ te.T / 0.1

    logits = apply

    def apply_taps(self, x: torch.Tensor):
        return self.module.encode_image(x, taps=True)

    def apply_probed(self, x: torch.Tensor, probes: dict):
        return self.module.encode_image(x, probes=probes, taps=True)


def _normalized(te: torch.Tensor) -> torch.Tensor:
    return te / torch.linalg.vector_norm(te, dim=-1, keepdim=True)


# prompts the text tower encodes at a time (xai_tpu's attach_text_table)
TEXT_CHUNK = 125


def class_prompt_tokens() -> np.ndarray:
    """The reference's 1000-class prompt table "a photo of a {label}",
    tokenized with the BPE vocabulary (evaluatePerturbation.py:698-704):
    ``[1000, 77]`` int32."""
    from ..data.tokenizer import class_prompts, default_tokenizer
    return default_tokenizer().tokenize(class_prompts())


@torch.no_grad()
def encode_text_table(module: CLIP, tokens: torch.Tensor) -> torch.Tensor:
    """The normalized float32 text embeddings of ``[T, L]`` ids, encoded
    ``TEXT_CHUNK`` prompts at a time."""
    embs = [module.encode_text(tokens[i:i + TEXT_CHUNK]).float()
            for i in range(0, tokens.shape[0], TEXT_CHUNK)]
    return _normalized(torch.cat(embs))


def attach_text_table(bundle: CLIPBundle, tokens=None) -> CLIPBundle:
    """The bundle with its text table rebuilt by its own text tower from
    ``tokens`` (``[T, L]`` ids; by default the bundle's own), normalized;
    the ids are kept as ``extras["text_tokens_table"]`` for the
    explainers that take tokens (game, lrp).  The sanity driver rebuilds
    the table of its randomized model so (evaluateSanity.py:610)."""
    tokens = bundle.text_tokens if tokens is None else torch.as_tensor(
        tokens, dtype=torch.int64, device=bundle.device)
    te = encode_text_table(bundle.module, tokens)
    return CLIPBundle(dataclasses.replace(bundle.meta,
                                          num_classes=te.shape[0]),
                      bundle.module, te, tokens)


def make_bundle(arch_or_cli: str, state: Optional[dict] = None,
                seed: int = 0, batch_size: int = 25,
                device=None) -> CLIPBundle:
    """The bundle of a CLIP arch or CLI name: seeded random weights
    (:func:`init_random`), or ``state`` (a state dict, e.g. from
    ``convert/from_jax.py load_params``), on ``device``, with the
    class-prompt table of its own text tower, built after the weights are
    in, as the reference encodes it once at driver start
    (evaluatePerturbation.py:698-704)."""
    cfg = CONFIGS[CLI_ARCH.get(arch_or_cli, arch_or_cli)]
    model = init_random(CLIP(cfg), seed)
    if state is not None:
        model.load_state_dict(state)
    model = model.to(device)
    tokens = torch.as_tensor(class_prompt_tokens(), dtype=torch.int64,
                             device=next(model.parameters()).device)
    te = encode_text_table(model, tokens)
    meta = ModelMeta(name=arch_or_cli, family="clip", img_hw=cfg.img_hw,
                     num_classes=te.shape[0], num_patches=cfg.grid,
                     batch_size=batch_size, mean=CLIP_MEAN, std=CLIP_STD)
    return CLIPBundle(meta, model, te, tokens)


def batch_extras(bundle: CLIPBundle, targets) -> dict:
    """A batch's CLIP extras, a row an image: ``txt_emb`` ``[B, E]`` and,
    where the bundle has the prompt table, ``text_tokens`` ``[B, L]``
    (``methods/batch.py batch_attribution``'s ``extras``)."""
    rows = [clip_extras(bundle, int(t)) for t in targets]
    return {k: torch.cat([r[k] for r in rows]) for k in rows[0]}


def clip_extras(bundle: CLIPBundle, target: int) -> dict:
    """One image's CLIP attribution context: its target's prompt
    embedding ``txt_emb`` ``[1, E]`` and, where the bundle has the prompt
    table, its ids ``text_tokens`` ``[1, L]`` (the reference tokenizes
    "a photo of a {label}" at evaluatePerturbation.py:388)."""
    ex = {"txt_emb": bundle.text_embeddings[target][None]}
    if bundle.text_tokens is not None:
        ex["text_tokens"] = bundle.text_tokens[target][None]
    return ex
