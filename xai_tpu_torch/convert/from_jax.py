"""The weight carry: ``xai_tpu`` params -> the port's state dict.

``xai_tpu.runners.common.save_params`` writes a params pytree to ``.npz``
with flat ``a/b/c`` keys (e.g. ``layer3_7/conv2/kernel``).  This module
reads that file and renames and transposes each array into the port's
``nn.Module`` layout, so one ``--params_path`` file serves both packages:

- conv ``kernel`` HWIO -> ``weight`` OIHW (also right for grouped convs,
  whose HWIO kernel is ``[kh, kw, in/groups, out]``, and for the ViT's
  ``patch_embed``);
- dense ``kernel`` ``[in, out]`` -> ``weight`` ``[out, in]`` (the ViT's
  ``attn/qkv``, ``attn/proj``, ``mlp_fc1``, ``mlp_fc2`` and ``head`` too);
- everything else as is: folded-BN and LayerNorm ``scale``/``bias`` (the
  port's ``FoldedBN`` and ``LayerNorm`` keep flax's names), dense and conv
  ``bias``, the ViT's ``cls_token`` and ``pos_embed``.

Only ``.npz`` is read: ``.msgpack`` needs flax, and pickle runs code.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_STAGE_BLOCK = re.compile(r"^layer(\d+)_(\d+)/")


def state_dict_from_jax(flat: Mapping[str, np.ndarray]
                        ) -> Dict[str, torch.Tensor]:
    """Flat ``a/b/c``-keyed JAX params -> the port's state dict."""
    out = {}
    for key, value in flat.items():
        arr = np.asarray(value)
        name = _STAGE_BLOCK.sub(r"layer\1.\2/", key)
        *path, leaf = name.split("/")
        if leaf == "kernel":
            leaf = "weight"
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T
            else:
                raise ValueError(f"unexpected kernel rank {arr.ndim}: {key}")
        out[".".join(path + [leaf])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return out


def jax_leaf_name(name: str) -> str:
    """The flat ``a/b/c`` key of the JAX leaf that the port's parameter
    ``name`` carries (the inverse of :func:`state_dict_from_jax`'s
    renaming; a conv or dense ``weight`` is a ``kernel`` there)."""
    name = re.sub(r"^layer(\d+)\.(\d+)\.", r"layer\1_\2.", name)
    *path, leaf = name.split(".")
    return "/".join(path + ["kernel" if leaf == "weight" else leaf])


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """Read an ``xai_tpu``-saved ``.npz`` into the port's state dict."""
    if not path.endswith(".npz"):
        raise ValueError(f"unsupported params format: {path} (the port "
                         "reads only .npz; convert .msgpack with xai_tpu's "
                         "save_params(load_params(p), 'x.npz'))")
    with np.load(path) as flat:
        return state_dict_from_jax({k: flat[k] for k in flat.files})
