"""torch state dicts -> xai_tpu's parameter layout -> the port's state dict.

The port's own copy of xai_tpu's converters (``xai_tpu/convert/
torch_import.py`` and the ``*_from_torch`` / ``*_from_hf`` functions of
its model files): each maps a torchvision, timm, openai-CLIP or
HuggingFace state dict to xai_tpu's nested parameter tree, array for
array as xai_tpu does, so both packages get the same numbers from one
checkpoint.  :func:`from_torch` then flattens the tree with
``save_params``'s ``a/b/c`` rule and carries it into the port's state
dict (``convert/from_jax.py``); ``convert/cli.py`` writes the flat tree
as the ``.npz`` that every driver's ``--params_path`` reads.

Conventions handled:
- torchvision ResNet/ResNeXt naming (``layer1.0.conv1.weight``,
  ``layer1.0.downsample.0.weight`` ...), BatchNorm folded to scale/bias
  (eps 1e-5; Inception-v3's and MaxViT's 1e-3);
- torchvision VGG naming (``features.N.weight``, ``classifier.{0,3,6}``);
- timm and torchvision ViT, torchvision MaxViT, ConvNeXt, Inception-v3
  and Swin, HuggingFace Swin and PVT, openai and HuggingFace CLIP.

Every function takes a mapping name -> array (torch tensors or numpy
arrays) and imports nothing but numpy.  As in xai_tpu, the converters of
``xai_tpu/convert/torch_import.py`` cast floating arrays to float32, and
those of the model files (ConvNeXt, Inception-v3, Swin, PVT) keep the
checkpoint's dtype.
"""
from __future__ import annotations

import numpy as np

BN_EPS = 1e-5


def _np(t):
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    t = np.asarray(t)
    # checkpoints may carry fp16 (openai CLIP stores half); our master
    # copy is f32 — compute dtype is a runtime choice (attr_dtype)
    if np.issubdtype(t.dtype, np.floating) and t.dtype != np.float32:
        t = t.astype(np.float32)
    return t


def _conv(w):
    """torch OIHW -> flax HWIO."""
    return _np(w).transpose(2, 3, 1, 0)


def _dense(w):
    """torch [out, in] -> flax [in, out]."""
    return _np(w).T


def _raw(t):
    """An array as the checkpoint stores it (no dtype cast)."""
    return t.detach().cpu().numpy() if hasattr(t, "detach") else \
        np.asarray(t)


def _raw_conv(w):
    return _raw(w).transpose(2, 3, 1, 0)


def _raw_dense(w):
    return _raw(w).T


def _raw_ln(sd, prefix):
    return {"scale": _raw(sd[prefix + ".weight"]),
            "bias": _raw(sd[prefix + ".bias"])}


def _fold_bn(sd, prefix, eps=BN_EPS):
    gamma = _np(sd[prefix + ".weight"])
    beta = _np(sd[prefix + ".bias"])
    mean = _np(sd[prefix + ".running_mean"])
    var = _np(sd[prefix + ".running_var"])
    scale = gamma / np.sqrt(var + eps)
    return {"scale": scale, "bias": beta - mean * scale}


def resnet_from_torch(sd, layers) -> dict:
    """Convert a torchvision-style ResNet/ResNeXt state dict.

    layers: per-stage block counts, e.g. (3, 4, 23, 3) for ResNet-101.
    """
    sd = {k: v for k, v in sd.items()}
    params = {
        "conv1": {"kernel": _conv(sd["conv1.weight"])},
        "bn1": _fold_bn(sd, "bn1"),
        "fc": {"kernel": _dense(sd["fc.weight"]), "bias": _np(sd["fc.bias"])},
    }
    for stage, blocks in enumerate(layers, start=1):
        for b in range(blocks):
            t = f"layer{stage}.{b}"
            blk = {}
            for j in (1, 2, 3):
                blk[f"conv{j}"] = {"kernel": _conv(sd[f"{t}.conv{j}.weight"])}
                blk[f"bn{j}"] = _fold_bn(sd, f"{t}.bn{j}")
            if f"{t}.downsample.0.weight" in sd:
                blk["downsample_conv"] = {
                    "kernel": _conv(sd[f"{t}.downsample.0.weight"])}
                blk["downsample_bn"] = _fold_bn(sd, f"{t}.downsample.1")
            params[f"layer{stage}_{b}"] = blk
    return params


def vgg_from_torch(sd) -> dict:
    params = {}
    conv_keys = sorted(
        (k for k in sd if k.startswith("features.") and k.endswith(".weight")),
        key=lambda k: int(k.split(".")[1]),
    )
    for i, wk in enumerate(conv_keys):
        bk = wk[: -len("weight")] + "bias"
        params[f"conv{i}"] = {"kernel": _conv(sd[wk]), "bias": _np(sd[bk])}
    fc_keys = sorted(
        (k for k in sd
         if k.startswith("classifier.") and k.endswith(".weight")),
        key=lambda k: int(k.split(".")[1]),
    )
    for i, wk in enumerate(fc_keys):
        bk = wk[: -len("weight")] + "bias"
        params[f"fc{i}"] = {"kernel": _dense(sd[wk]), "bias": _np(sd[bk])}
    return params


def _clip_block(sd, t):
    return {
        "ln_1": {"scale": _np(sd[f"{t}.ln_1.weight"]),
                 "bias": _np(sd[f"{t}.ln_1.bias"])},
        "ln_2": {"scale": _np(sd[f"{t}.ln_2.weight"]),
                 "bias": _np(sd[f"{t}.ln_2.bias"])},
        "attn": {
            "in_proj": {"kernel": _dense(sd[f"{t}.attn.in_proj_weight"]),
                        "bias": _np(sd[f"{t}.attn.in_proj_bias"])},
            "out_proj": {"kernel": _dense(sd[f"{t}.attn.out_proj.weight"]),
                         "bias": _np(sd[f"{t}.attn.out_proj.bias"])},
        },
        "mlp_c_fc": {"kernel": _dense(sd[f"{t}.mlp.c_fc.weight"]),
                     "bias": _np(sd[f"{t}.mlp.c_fc.bias"])},
        "mlp_c_proj": {"kernel": _dense(sd[f"{t}.mlp.c_proj.weight"]),
                       "bias": _np(sd[f"{t}.mlp.c_proj.bias"])},
    }


def clip_from_torch(sd, vision_layers: int = 12, text_layers: int = 12
                    ) -> dict:
    """Convert an openai-CLIP state dict (clip.load naming)."""
    visual = {
        "conv1": {"kernel": _conv(sd["visual.conv1.weight"])},
        "class_embedding": _np(sd["visual.class_embedding"]),
        "positional_embedding": _np(sd["visual.positional_embedding"]),
        "ln_pre": {"scale": _np(sd["visual.ln_pre.weight"]),
                   "bias": _np(sd["visual.ln_pre.bias"])},
        "ln_post": {"scale": _np(sd["visual.ln_post.weight"]),
                    "bias": _np(sd["visual.ln_post.bias"])},
        "proj": _np(sd["visual.proj"]),
    }
    for i in range(vision_layers):
        visual[f"block{i}"] = _clip_block(
            sd, f"visual.transformer.resblocks.{i}")
    text = {
        "token_embedding": _np(sd["token_embedding.weight"]),
        "positional_embedding": _np(sd["positional_embedding"]),
        "ln_final": {"scale": _np(sd["ln_final.weight"]),
                     "bias": _np(sd["ln_final.bias"])},
        "text_projection": _np(sd["text_projection"]),
    }
    for i in range(text_layers):
        text[f"block{i}"] = _clip_block(sd, f"transformer.resblocks.{i}")
    return {"visual": visual, "text": text,
            "logit_scale": _np(sd["logit_scale"])}


def vit_from_torchvision(sd, depth: int = 12) -> dict:
    """Convert a torchvision ViT state dict (models.vit_b_16/vit_b_32 —
    the weights behind the reference's VIT16/VIT32 class maps,
    findCorrectlyClassifiedImageNet.py:73-78).  torchvision packs qkv as
    MultiheadAttention in_proj; MLP layers live at mlp.{0,3} (linear_1/2 in
    newer versions use the same indices)."""
    params = {
        "patch_embed": {"kernel": _conv(sd["conv_proj.weight"]),
                        "bias": _np(sd["conv_proj.bias"])},
        "cls_token": _np(sd["class_token"]),
        "pos_embed": _np(sd["encoder.pos_embedding"]),
        "norm": {"scale": _np(sd["encoder.ln.weight"]),
                 "bias": _np(sd["encoder.ln.bias"])},
        "head": {"kernel": _dense(sd["heads.head.weight"]),
                 "bias": _np(sd["heads.head.bias"])},
    }
    for i in range(depth):
        t = f"encoder.layers.encoder_layer_{i}"
        mlp1 = f"{t}.mlp.0" if f"{t}.mlp.0.weight" in sd else \
            f"{t}.mlp.linear_1"
        mlp2 = f"{t}.mlp.3" if f"{t}.mlp.3.weight" in sd else \
            f"{t}.mlp.linear_2"
        params[f"block{i}"] = {
            "norm1": {"scale": _np(sd[f"{t}.ln_1.weight"]),
                      "bias": _np(sd[f"{t}.ln_1.bias"])},
            "norm2": {"scale": _np(sd[f"{t}.ln_2.weight"]),
                      "bias": _np(sd[f"{t}.ln_2.bias"])},
            "attn": {
                "qkv": {"kernel": _dense(
                    sd[f"{t}.self_attention.in_proj_weight"]),
                    "bias": _np(sd[f"{t}.self_attention.in_proj_bias"])},
                "proj": {"kernel": _dense(
                    sd[f"{t}.self_attention.out_proj.weight"]),
                    "bias": _np(sd[f"{t}.self_attention.out_proj.bias"])},
            },
            "mlp_fc1": {"kernel": _dense(sd[mlp1 + ".weight"]),
                        "bias": _np(sd[mlp1 + ".bias"])},
            "mlp_fc2": {"kernel": _dense(sd[mlp2 + ".weight"]),
                        "bias": _np(sd[mlp2 + ".bias"])},
        }
    return params


def maxvit_from_torch(sd, depths=(2, 2, 5, 2)) -> dict:
    """Convert a torchvision maxvit_t state dict (torchvision/models/
    maxvit.py naming: stem.{0,1}, blocks.B.layers.L.layers.{MBconv,
    window_attention,grid_attention}, classifier.{2,3,5}) into the
    models/maxvit.py MaxViTTV pytree.  BN folded with the torchvision
    norm_layer eps (1e-3); the final classifier Linear has no bias."""
    EPS = 1e-3

    def _ln(prefix):
        return {"scale": _np(sd[prefix + ".weight"]),
                "bias": _np(sd[prefix + ".bias"])}

    def _lin(prefix):
        return {"kernel": _dense(sd[prefix + ".weight"]),
                "bias": _np(sd[prefix + ".bias"])}

    def _se_fc(prefix):
        # SqueezeExcitation fc1/fc2 are 1x1 convs [out, in, 1, 1] -> Dense
        w = _np(sd[prefix + ".weight"])[:, :, 0, 0].T
        return {"kernel": w, "bias": _np(sd[prefix + ".bias"])}

    def _attn(prefix):
        return {
            "norm": _ln(f"{prefix}.attn_layer.0"),
            "attn": {
                "qkv": _lin(f"{prefix}.attn_layer.1.to_qkv"),
                "proj": _lin(f"{prefix}.attn_layer.1.merge"),
                "rel_bias_table": _np(
                    sd[f"{prefix}.attn_layer.1.relative_position_bias_table"]
                ),
            },
            "mlp_norm": _ln(f"{prefix}.mlp_layer.0"),
            "mlp_fc1": _lin(f"{prefix}.mlp_layer.1"),
            "mlp_fc2": _lin(f"{prefix}.mlp_layer.3"),
        }

    params = {
        "stem_conv1": {"kernel": _conv(sd["stem.0.0.weight"])},
        "stem_bn": _fold_bn(sd, "stem.0.1", eps=EPS),
        "stem_conv2": {"kernel": _conv(sd["stem.1.0.weight"]),
                       "bias": _np(sd["stem.1.0.bias"])},
        "head_norm": _ln("classifier.2"),
        "head_pre": _lin("classifier.3"),
        "head": {"kernel": _dense(sd["classifier.5.weight"])},
    }
    for s, depth in enumerate(depths):
        for b in range(depth):
            t = f"blocks.{s}.layers.{b}.layers"
            mb = {
                "pre_norm": _fold_bn(sd, f"{t}.MBconv.layers.pre_norm",
                                     eps=EPS),
                "conv_a": {"kernel": _conv(
                    sd[f"{t}.MBconv.layers.conv_a.0.weight"])},
                "bn_a": _fold_bn(sd, f"{t}.MBconv.layers.conv_a.1", eps=EPS),
                "conv_b": {"kernel": _conv(
                    sd[f"{t}.MBconv.layers.conv_b.0.weight"])},
                "bn_b": _fold_bn(sd, f"{t}.MBconv.layers.conv_b.1", eps=EPS),
                "se": {
                    "fc1": _se_fc(
                        f"{t}.MBconv.layers.squeeze_excitation.fc1"),
                    "fc2": _se_fc(
                        f"{t}.MBconv.layers.squeeze_excitation.fc2"),
                },
                "conv_c": {"kernel": _conv(
                    sd[f"{t}.MBconv.layers.conv_c.weight"]),
                    "bias": _np(sd[f"{t}.MBconv.layers.conv_c.bias"])},
            }
            # stride-2 first layer: proj = AvgPool + Conv1x1(bias) at .1
            if f"{t}.MBconv.proj.1.weight" in sd:
                mb["shortcut"] = {
                    "kernel": _conv(sd[f"{t}.MBconv.proj.1.weight"]),
                    "bias": _np(sd[f"{t}.MBconv.proj.1.bias"])}
            elif f"{t}.MBconv.proj.0.weight" in sd:   # stride-1 channel change
                mb["shortcut"] = {
                    "kernel": _conv(sd[f"{t}.MBconv.proj.0.weight"]),
                    "bias": _np(sd[f"{t}.MBconv.proj.0.bias"])}
            params[f"stage{s}_block{b}"] = {
                "mbconv": mb,
                "window_attn": _attn(f"{t}.window_attention"),
                "grid_attn": _attn(f"{t}.grid_attention"),
            }
    return params


def vit_from_torch(sd, depth: int = 12) -> dict:
    """Convert a timm-style ViT state dict (ViT_new_timm.py naming)."""
    params = {
        "patch_embed": {
            "kernel": _conv(sd["patch_embed.proj.weight"]),
            "bias": _np(sd["patch_embed.proj.bias"]),
        },
        "cls_token": _np(sd["cls_token"]),
        "pos_embed": _np(sd["pos_embed"]),
        "norm": {"scale": _np(sd["norm.weight"]),
                 "bias": _np(sd["norm.bias"])},
        "head": {"kernel": _dense(sd["head.weight"]),
                 "bias": _np(sd["head.bias"])},
    }
    for i in range(depth):
        t = f"blocks.{i}"
        params[f"block{i}"] = {
            "norm1": {"scale": _np(sd[f"{t}.norm1.weight"]),
                      "bias": _np(sd[f"{t}.norm1.bias"])},
            "norm2": {"scale": _np(sd[f"{t}.norm2.weight"]),
                      "bias": _np(sd[f"{t}.norm2.bias"])},
            "attn": {
                "qkv": {"kernel": _dense(sd[f"{t}.attn.qkv.weight"]),
                        "bias": _np(sd[f"{t}.attn.qkv.bias"])},
                "proj": {"kernel": _dense(sd[f"{t}.attn.proj.weight"]),
                         "bias": _np(sd[f"{t}.attn.proj.bias"])},
            },
            "mlp_fc1": {"kernel": _dense(sd[f"{t}.mlp.fc1.weight"]),
                        "bias": _np(sd[f"{t}.mlp.fc1.bias"])},
            "mlp_fc2": {"kernel": _dense(sd[f"{t}.mlp.fc2.weight"]),
                        "bias": _np(sd[f"{t}.mlp.fc2.bias"])},
        }
    return params


def clip_from_hf(sd, vision_layers: int = 12, text_layers: int = 12
                 ) -> dict:
    """Convert a HuggingFace ``transformers.CLIPModel`` state dict.

    Maps the HF naming (vision_model.encoder.layers.N.self_attn.q/k/v_proj,
    visual_projection, pre_layrnorm [sic]) onto the openai-CLIP layout and
    reuses :func:`clip_from_torch`."""
    oa = {}

    def blk(dst, src, n):
        for i in range(n):
            d, s = f"{dst}.{i}", f"{src}.{i}"
            for part in ("weight", "bias"):
                oa[f"{d}.attn.in_proj_{part}"] = np.concatenate(
                    [_raw(sd[f"{s}.self_attn.q_proj.{part}"]),
                     _raw(sd[f"{s}.self_attn.k_proj.{part}"]),
                     _raw(sd[f"{s}.self_attn.v_proj.{part}"])])
                oa[f"{d}.attn.out_proj.{part}"] = \
                    sd[f"{s}.self_attn.out_proj.{part}"]
                oa[f"{d}.ln_1.{part}"] = sd[f"{s}.layer_norm1.{part}"]
                oa[f"{d}.ln_2.{part}"] = sd[f"{s}.layer_norm2.{part}"]
                oa[f"{d}.mlp.c_fc.{part}"] = sd[f"{s}.mlp.fc1.{part}"]
                oa[f"{d}.mlp.c_proj.{part}"] = sd[f"{s}.mlp.fc2.{part}"]

    v = "vision_model"
    oa["visual.conv1.weight"] = sd[f"{v}.embeddings.patch_embedding.weight"]
    oa["visual.class_embedding"] = sd[f"{v}.embeddings.class_embedding"]
    oa["visual.positional_embedding"] = \
        sd[f"{v}.embeddings.position_embedding.weight"]
    for part in ("weight", "bias"):
        oa[f"visual.ln_pre.{part}"] = sd[f"{v}.pre_layrnorm.{part}"]
        oa[f"visual.ln_post.{part}"] = sd[f"{v}.post_layernorm.{part}"]
        oa[f"ln_final.{part}"] = sd[f"text_model.final_layer_norm.{part}"]
    blk("visual.transformer.resblocks", f"{v}.encoder.layers", vision_layers)
    oa["visual.proj"] = _raw(sd["visual_projection.weight"]).T

    t = "text_model"
    oa["token_embedding.weight"] = \
        sd[f"{t}.embeddings.token_embedding.weight"]
    oa["positional_embedding"] = \
        sd[f"{t}.embeddings.position_embedding.weight"]
    blk("transformer.resblocks", f"{t}.encoder.layers", text_layers)
    oa["text_projection"] = _raw(sd["text_projection.weight"]).T
    oa["logit_scale"] = sd["logit_scale"]
    return clip_from_torch(oa, vision_layers, text_layers)


def convnext_from_torch(sd, depths) -> dict:
    """Convert a torchvision ConvNeXt state dict (features.N layout):
    features.0 = stem (conv, LN); odd indices = downsample (LN, conv);
    even >0 = stages of CNBlocks (block.0 dwconv, block.2 LN, block.3
    Linear, block.5 Linear, layer_scale); classifier.0 LN, classifier.2
    Linear."""
    params = {
        "stem_conv": {"kernel": _raw_conv(sd["features.0.0.weight"]),
                      "bias": _raw(sd["features.0.0.bias"])},
        "stem_norm": {"scale": _raw(sd["features.0.1.weight"]),
                      "bias": _raw(sd["features.0.1.bias"])},
        "head_norm": {"scale": _raw(sd["classifier.0.weight"]),
                      "bias": _raw(sd["classifier.0.bias"])},
        "head": {"kernel": _raw_dense(sd["classifier.2.weight"]),
                 "bias": _raw(sd["classifier.2.bias"])},
    }
    for s in range(len(depths)):
        feat_idx = 1 + 2 * s
        if s > 0:
            dn = f"features.{2 * s}"
            params[f"down{s}_norm"] = {"scale": _raw(sd[f"{dn}.0.weight"]),
                                       "bias": _raw(sd[f"{dn}.0.bias"])}
            params[f"down{s}_conv"] = {
                "kernel": _raw_conv(sd[f"{dn}.1.weight"]),
                "bias": _raw(sd[f"{dn}.1.bias"])}
        for b in range(depths[s]):
            t = f"features.{feat_idx}.{b}.block"
            params[f"stage{s}_block{b}"] = {
                "dwconv": {"kernel": _raw_conv(sd[f"{t}.0.weight"]),
                           "bias": _raw(sd[f"{t}.0.bias"])},
                "norm": {"scale": _raw(sd[f"{t}.2.weight"]),
                         "bias": _raw(sd[f"{t}.2.bias"])},
                "pw1": {"kernel": _raw_dense(sd[f"{t}.3.weight"]),
                        "bias": _raw(sd[f"{t}.3.bias"])},
                "pw2": {"kernel": _raw_dense(sd[f"{t}.5.weight"]),
                        "bias": _raw(sd[f"{t}.5.bias"])},
                # torchvision stores layer_scale as [dim, 1, 1] (NCHW)
                "gamma": _raw(
                    sd[f"features.{feat_idx}.{b}.layer_scale"]).reshape(-1),
            }
    return params


def inception_from_torch(sd) -> dict:
    """Convert a torchvision inception_v3 state dict (aux head skipped);
    BN folded with eps 1e-3."""
    def fold(prefix):
        g = _raw(sd[prefix + ".bn.weight"])
        b = _raw(sd[prefix + ".bn.bias"])
        m = _raw(sd[prefix + ".bn.running_mean"])
        v = _raw(sd[prefix + ".bn.running_var"])
        scale = g / np.sqrt(v + 1e-3)
        return {"conv": {"kernel": _raw_conv(sd[prefix + ".conv.weight"])},
                "bn": {"scale": scale, "bias": b - m * scale}}

    params = {}
    units = set()
    for k in sd:
        if k.endswith(".conv.weight") and not k.startswith("AuxLogits"):
            units.add(k[: -len(".conv.weight")])
    for u in sorted(units):
        parts = u.split(".")
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = fold(u)
    params["fc"] = {"kernel": _raw(sd["fc.weight"]).T,
                    "bias": _raw(sd["fc.bias"])}
    return params


def swin_from_torch(sd, depths) -> dict:
    """Convert a torchvision Swin state dict (features.N layout):
    features.0 = stem (Conv2d at .0, LN at .2); odd indices = stages of
    SwinTransformerBlocks (norm1/attn.qkv/attn.proj/
    attn.relative_position_bias_table/norm2/mlp.{0,3}); even >0 =
    PatchMerging (reduction Linear, norm LN); final norm + head."""

    params = {
        "patch_embed": {"kernel": _raw_conv(sd["features.0.0.weight"]),
                        "bias": _raw(sd["features.0.0.bias"])},
        "patch_norm": _raw_ln(sd, "features.0.2"),
        "norm": _raw_ln(sd, "norm"),
        "head": {"kernel": _raw_dense(sd["head.weight"]),
                 "bias": _raw(sd["head.bias"])},
    }
    for s in range(len(depths)):
        if s > 0:
            t = f"features.{2 * s}"
            params[f"merge{s}"] = {
                "norm": _raw_ln(sd, f"{t}.norm"),
                "reduction": {
                    "kernel": _raw_dense(sd[f"{t}.reduction.weight"])},
            }
        for b in range(depths[s]):
            t = f"features.{2 * s + 1}.{b}"
            params[f"stage{s}_block{b}"] = {
                "norm1": _raw_ln(sd, f"{t}.norm1"),
                "norm2": _raw_ln(sd, f"{t}.norm2"),
                "attn": {
                    "qkv": {"kernel": _raw_dense(sd[f"{t}.attn.qkv.weight"]),
                            "bias": _raw(sd[f"{t}.attn.qkv.bias"])},
                    "proj": {"kernel": _raw_dense(sd[f"{t}.attn.proj.weight"]),
                             "bias": _raw(sd[f"{t}.attn.proj.bias"])},
                    "rel_bias_table": _raw(
                        sd[f"{t}.attn.relative_position_bias_table"]),
                },
                "mlp_fc1": {"kernel": _raw_dense(sd[f"{t}.mlp.0.weight"]),
                            "bias": _raw(sd[f"{t}.mlp.0.bias"])},
                "mlp_fc2": {"kernel": _raw_dense(sd[f"{t}.mlp.3.weight"]),
                            "bias": _raw(sd[f"{t}.mlp.3.bias"])},
            }
    return params


def swin_from_hf(sd, depths) -> dict:
    """Convert a HuggingFace SwinForImageClassification state dict (the
    checkpoints the reference's image_finder loads:
    microsoft/swin-{tiny,small,base}-patch4-window7-224).  HF keeps q/k/v
    separate and hangs each stage's downsample off the PREVIOUS layer."""

    params = {
        "patch_embed": {
            "kernel": _raw_conv(sd["swin.embeddings.patch_embeddings."
                                   "projection.weight"]),
            "bias": _raw(sd["swin.embeddings.patch_embeddings."
                            "projection.bias"])},
        "patch_norm": _raw_ln(sd, "swin.embeddings.norm"),
        "norm": _raw_ln(sd, "swin.layernorm"),
        "head": {"kernel": _raw_dense(sd["classifier.weight"]),
                 "bias": _raw(sd["classifier.bias"])},
    }
    for s in range(len(depths)):
        if s > 0:
            t = f"swin.encoder.layers.{s - 1}.downsample"
            params[f"merge{s}"] = {
                "norm": _raw_ln(sd, f"{t}.norm"),
                "reduction": {
                    "kernel": _raw_dense(sd[f"{t}.reduction.weight"])},
            }
        for b in range(depths[s]):
            t = f"swin.encoder.layers.{s}.blocks.{b}"
            q = _raw_dense(sd[f"{t}.attention.self.query.weight"])
            k = _raw_dense(sd[f"{t}.attention.self.key.weight"])
            v = _raw_dense(sd[f"{t}.attention.self.value.weight"])
            qb = _raw(sd[f"{t}.attention.self.query.bias"])
            kb = _raw(sd[f"{t}.attention.self.key.bias"])
            vb = _raw(sd[f"{t}.attention.self.value.bias"])
            params[f"stage{s}_block{b}"] = {
                "norm1": _raw_ln(sd, f"{t}.layernorm_before"),
                "norm2": _raw_ln(sd, f"{t}.layernorm_after"),
                "attn": {
                    "qkv": {"kernel": np.concatenate([q, k, v], axis=1),
                            "bias": np.concatenate([qb, kb, vb])},
                    "proj": {"kernel": _raw_dense(
                        sd[f"{t}.attention.output.dense.weight"]),
                        "bias": _raw(
                            sd[f"{t}.attention.output.dense.bias"])},
                    "rel_bias_table": _raw(
                        sd[f"{t}.attention.self."
                           "relative_position_bias_table"]),
                },
                "mlp_fc1": {"kernel": _raw_dense(
                    sd[f"{t}.intermediate.dense.weight"]),
                    "bias": _raw(sd[f"{t}.intermediate.dense.bias"])},
                "mlp_fc2": {"kernel": _raw_dense(
                    sd[f"{t}.output.dense.weight"]),
                    "bias": _raw(sd[f"{t}.output.dense.bias"])},
            }
    return params


def pvt_from_hf(sd, depths) -> dict:
    """Convert a HuggingFace PvtForImageClassification state dict
    (the checkpoints the reference's image_finder loads:
    Xrenya/pvt-{tiny,small}-224, Zetatech/pvt-medium-224)."""
    params = {
        "norm": _raw_ln(sd, "pvt.encoder.layer_norm"),
        "head": {"kernel": _raw_dense(sd["classifier.weight"]),
                 "bias": _raw(sd["classifier.bias"])},
    }
    n = len(depths)
    for s in range(n):
        pe = f"pvt.encoder.patch_embeddings.{s}"
        params[f"patch_embed{s}"] = {
            "kernel": _raw_conv(sd[f"{pe}.projection.weight"]),
            "bias": _raw(sd[f"{pe}.projection.bias"])}
        params[f"embed_norm{s}"] = _raw_ln(sd, f"{pe}.layer_norm")
        pos = _raw(sd[f"{pe}.position_embeddings"])
        params[f"pos_embed{s}"] = pos
        if s == n - 1:
            params["cls_token"] = _raw(sd[f"{pe}.cls_token"])
        for b in range(depths[s]):
            t = f"pvt.encoder.block.{s}.{b}"
            q = _raw_dense(sd[f"{t}.attention.self.query.weight"])
            k = _raw_dense(sd[f"{t}.attention.self.key.weight"])
            v = _raw_dense(sd[f"{t}.attention.self.value.weight"])
            qb = _raw(sd[f"{t}.attention.self.query.bias"])
            kb = _raw(sd[f"{t}.attention.self.key.bias"])
            vb = _raw(sd[f"{t}.attention.self.value.bias"])
            blk = {
                "norm1": _raw_ln(sd, f"{t}.layer_norm_1"),
                "norm2": _raw_ln(sd, f"{t}.layer_norm_2"),
                "attn": {
                    "q": {"kernel": q, "bias": qb},
                    "kv": {"kernel": np.concatenate([k, v], axis=1),
                           "bias": np.concatenate([kb, vb])},
                    "proj": {"kernel": _raw_dense(
                        sd[f"{t}.attention.output.dense.weight"]),
                        "bias": _raw(sd[f"{t}.attention.output.dense.bias"])},
                },
                "mlp_fc1": {"kernel": _raw_dense(sd[f"{t}.mlp.dense1.weight"]),
                            "bias": _raw(sd[f"{t}.mlp.dense1.bias"])},
                "mlp_fc2": {"kernel": _raw_dense(
                    sd[f"{t}.mlp.dense2.weight"]),
                    "bias": _raw(sd[f"{t}.mlp.dense2.bias"])},
            }
            if f"{t}.attention.self.sequence_reduction.weight" in sd:
                blk["attn"]["sr"] = {
                    "kernel": _raw_conv(
                        sd[f"{t}.attention.self.sequence_reduction.weight"]),
                    "bias": _raw(
                        sd[f"{t}.attention.self.sequence_reduction.bias"])}
                blk["attn"]["sr_norm"] = _raw_ln(
                    sd, f"{t}.attention.self.layer_norm")
            params[f"stage{s}_block{b}"] = blk
    return params


def flatten(tree, prefix: str = "") -> dict:
    """A nested parameter tree -> ``{"a/b/c": array}``, the keys that
    xai_tpu's ``save_params`` writes to ``.npz``."""
    flat = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            flat.update(flatten(value, f"{prefix}{key}/"))
        else:
            flat[f"{prefix}{key}"] = np.asarray(value)
    return flat


# xai_tpu's ARCH_CONVERTERS: arch -> (converter, its keyword arguments)
ARCH_CONVERTERS = {
    "R50": ("resnet_from_torch", dict(layers=(3, 4, 6, 3))),
    "R101": ("resnet_from_torch", dict(layers=(3, 4, 23, 3))),
    "R152": ("resnet_from_torch", dict(layers=(3, 8, 36, 3))),
    "RNXT": ("resnet_from_torch", dict(layers=(3, 4, 23, 3))),
    "VGG16": ("vgg_from_torch", {}),
    "VGG19": ("vgg_from_torch", {}),
    "VIT16": ("vit_from_torch", dict(depth=12)),
    "VIT32": ("vit_from_torch", dict(depth=12)),
    "VIT16_torchvision": ("vit_from_torchvision", dict(depth=12)),
    "VIT32_torchvision": ("vit_from_torchvision", dict(depth=12)),
    "CONVNXT_large": ("convnext_from_torch", dict(depths=(3, 3, 27, 3))),
    "CLIP16": ("clip_from_torch", dict(vision_layers=12, text_layers=12)),
    "CLIP32": ("clip_from_torch", dict(vision_layers=12, text_layers=12)),
    "IV3": ("inception_from_torch", {}),
    "MAXVIT": ("maxvit_from_torch", dict(depths=(2, 2, 5, 2))),
    "CONVNXT": ("convnext_from_torch", dict(depths=(3, 3, 27, 3))),
    # HF checkpoints (microsoft/swin-*, Xrenya/pvt-*, Zetatech/pvt-medium)
    "swin_tiny": ("swin_from_hf", dict(depths=(2, 2, 6, 2))),
    "swin_small": ("swin_from_hf", dict(depths=(2, 2, 18, 2))),
    "swin_base": ("swin_from_hf", dict(depths=(2, 2, 18, 2))),
    "swin_tiny_torchvision": ("swin_from_torch", dict(depths=(2, 2, 6, 2))),
    "pvt_tiny": ("pvt_from_hf", dict(depths=(2, 2, 2, 2))),
    "pvt_small": ("pvt_from_hf", dict(depths=(3, 4, 6, 3))),
    "pvt_med": ("pvt_from_hf", dict(depths=(3, 4, 18, 3))),
}


def convert(arch: str, sd) -> dict:
    """A state dict in ``arch``'s source layout -> xai_tpu's nested tree."""
    name, kwargs = ARCH_CONVERTERS[arch]
    return globals()[name](sd, **kwargs)


def from_torch(arch: str, sd) -> dict:
    """A state dict in ``arch``'s source layout -> the port's state dict."""
    from .from_jax import state_dict_from_jax
    return state_dict_from_jax(flatten(convert(arch, sd)))
