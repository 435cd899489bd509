"""Seeded random weights, made on the device in one draw.

The reference module of a configuration's family lists every weight as
``(name, shape, kind)`` (``param_spec``); the names are those of the
program's state dict, so one dict loads into the program strictly and
feeds the reference as it is.  One ``torch.randn`` on the device draws
every random leaf at once from a generator seeded by ``--seed``; each
leaf is then a scaled slice of it.  The same seed on the same device
gives the same weights, so the benchmark makes them again for the
reference once the program's copy is gone.

Kinds (the gains come from the configuration file's ``init``):
``conv`` He-normal, std sqrt(2 / fan_in); ``linear`` LeCun-normal, std
1 / sqrt(fan_in); ``head`` LeCun-normal times ``head_gain``; ``embed``
normal(0, 0.02); ``shift`` normal(0, ``shift_std``); ``scale`` 1;
``branch_scale`` ``branch_scale`` (the last scale of a residual branch,
which keeps an un-normalized deep ResNet's activations in range);
``one`` 1; ``zero`` 0.
"""
from __future__ import annotations

import math

import numpy as np
import torch

RANDOM_KINDS = ("conv", "linear", "head", "embed", "shift")


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each use of ``--seed`` (weights,
    images, the sample of compared steps)."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(
        1, np.uint64)[0] >> 1)


def _std(kind: str, shape, init: dict) -> float:
    fan_in = math.prod(shape[1:])
    if kind == "conv":
        return math.sqrt(2.0 / fan_in)
    if kind == "linear":
        return 1.0 / math.sqrt(fan_in)
    if kind == "head":
        return init.get("head_gain", 1.0) / math.sqrt(fan_in)
    if kind == "embed":
        return 0.02
    return init.get("shift_std", 0.0)


@torch.no_grad()
def make_weights(spec: list, init: dict, seed: int, device) -> dict:
    """``{name: float32 tensor}`` on ``device`` for ``spec``."""
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 0))
    n = sum(math.prod(s) for _, s, k in spec if k in RANDOM_KINDS)
    draw = torch.randn(n, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in spec:
        if kind in RANDOM_KINDS:
            size = math.prod(shape)
            out[name] = draw[at:at + size].view(shape) * _std(kind, shape,
                                                              init)
            at += size
        else:
            value = {"scale": 1.0, "one": 1.0, "zero": 0.0,
                     "branch_scale": init.get("branch_scale", 1.0)}[kind]
            out[name] = torch.full(shape, value, device=device)
    return out
