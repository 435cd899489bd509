"""The in-process device mesh: a ``[data, model]`` grid of torch devices.

Counterpart of ``xai_tpu/parallel/mesh.py``.  xai_tpu lays its devices
out as a ``jax.sharding.Mesh`` and lets XLA split the work from
shardings; the port runs the same plan by hand.  Images split over the
``data`` axis (:func:`shard_batch`: one contiguous shard a row), each
row runs its shard on its own device (:func:`replicate`), and a ViT's
blocks may split over the ``model`` axis (:func:`vit_param_spec`,
:class:`TensorParallelViT`: the Megatron column / row split, two sums a
block).

A device list that repeats one device is the counterpart of xai_tpu's
virtual CPU mesh (``--xla_force_host_platform_device_count``): the split,
the gather, the tensor-parallel sums and the ragged shards all run, on
one card or on the CPU.  :func:`make_mesh` takes every visible CUDA card
unless it is given ``devices``; it never falls back to the CPU.
"""
from __future__ import annotations

import copy
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def canonical_device(device) -> torch.device:
    """``device`` with its index filled in (``cuda`` is the current card),
    so that equal devices compare and hash equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """A ``[data, model]`` array of ``torch.device``: ``devices[r]`` is data
    row ``r``, its entries the row's model ranks.  Entries may repeat."""

    axis_names = ("data", "model")

    def __init__(self, devices: Sequence[Sequence]):
        rows = tuple(tuple(canonical_device(d) for d in row)
                     for row in devices)
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError(f"Mesh: need a non-empty rectangular device "
                             f"array, got {rows}")
        self.devices = rows

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def distinct(self) -> list:
        """Each device once, in the order of its first entry."""
        return list(dict.fromkeys(d for row in self.devices for d in row))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[[str(d) for d in row] for row in self.devices]})")


def make_mesh(n_devices: Optional[int] = None, model_axis: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """The first ``n_devices`` (default: all) of ``devices`` (default:
    every visible CUDA card) as ``n_devices // model_axis`` data rows of
    ``model_axis`` ranks."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices= to "
                "build a mesh of other devices (a repeated device makes a "
                "virtual mesh)")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [canonical_device(d) for d in devices]
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(
            f"make_mesh: asked for {n} devices but the "
            f"{devices[0].type!r} device list exposes only {len(devices)}. "
            f"For a virtual mesh on one device, repeat it: devices="
            f"[torch.device({str(devices[0])!r})] * {n}")
    if n % model_axis != 0:
        raise ValueError(
            f"make_mesh: n_devices={n} not divisible by "
            f"model_axis={model_axis}")
    return Mesh([devices[i:i + model_axis]
                 for i in range(0, n, model_axis)])


def shard_slices(mesh: Mesh, n: int) -> list:
    """``[(row, slice)]``: the contiguous shards of ``n`` items over the
    data rows as ``torch.tensor_split`` cuts them (ragged: sizes differ by
    at most one, the larger first); a row whose shard is empty is
    skipped."""
    out, start = [], 0
    rows = mesh.shape["data"]
    for r in range(rows):
        size = n // rows + (r < n % rows)
        if size:
            out.append((r, slice(start, start + size)))
        start += size
    return out


def shard_batch(mesh: Mesh, x: torch.Tensor) -> list:
    """``[(row, shard)]``: one contiguous shard of ``x``'s leading axis per
    data row (:func:`shard_slices`), on the row's first device.  xai_tpu
    pads a batch to the data axis because SPMD needs equal shards; each
    image's result is the same either way."""
    return [(r, x[sl].to(mesh.devices[r][0]))
            for r, sl in shard_slices(mesh, x.shape[0])]


def _device_of(obj) -> torch.device:
    if isinstance(obj, nn.Module):
        first = next(iter(obj.parameters()), None)
        return torch.device("cpu") if first is None else first.device
    return obj.device


def replicate(mesh: Mesh, obj) -> dict:
    """``{device: replica}``, one a distinct device of the mesh.  ``obj``
    is an ``nn.Module`` or a ``ModelBundle``; on its own device it is
    reused, elsewhere copied (a virtual mesh on the model's device makes
    no copy)."""
    here = canonical_device(_device_of(obj))
    out = {}
    for d in mesh.distinct():
        if d == here:
            out[d] = obj
        elif isinstance(obj, nn.Module):
            out[d] = copy.deepcopy(obj).to(d)
        else:
            out[d] = obj.to(d)
    return out


def row_forwards(mesh: Mesh, obj, param_spec: Optional[dict] = None
                 ) -> list:
    """The forward of each data row, input and logits on the row's first
    device.  ``obj``: an ``nn.Module``, or a ``ModelBundle`` (its
    ``apply``).  Without ``param_spec``, a replica on the row's first
    device (:func:`replicate`; xai_tpu replicates the params over the
    model axis, so the row's other ranks would repeat its work); with
    it, a :class:`TensorParallelViT` over the row's devices, one for
    rows of the same devices."""
    if param_spec is None:
        reps = replicate(mesh, obj)
        # a bundle's forward is its apply (nn.Module.apply is another thing)
        return [reps[row[0]] if isinstance(obj, nn.Module)
                else reps[row[0]].apply for row in mesh.devices]
    module = obj if isinstance(obj, nn.Module) else obj.module
    built = {}
    for row in mesh.devices:
        if row not in built:
            built[row] = TensorParallelViT(module, row, param_spec)
    return [built[row] for row in mesh.devices]


# the tensor-parallel leaves of a ViT block and the dimension each splits
# (torch's [out, in] weights: xai_tpu's kernel columns are dim 0, its rows
# dim 1); xai_tpu/parallel/mesh.py:49-63
_SPLIT = {"attn.qkv.weight": 0, "attn.qkv.bias": 0, "attn.proj.weight": 1,
          "mlp_fc1.weight": 0, "mlp_fc1.bias": 0, "mlp_fc2.weight": 1}


def vit_param_spec(model: nn.Module) -> dict:
    """``{parameter name: split dimension or None}`` for a port
    ``VisionTransformer``: the MLP's hidden units and the attention's heads
    split over the ``model`` axis (fc1 by rows, fc2 by columns; qkv by
    rows, proj by columns), everything else replicated, as xai_tpu's spec
    splits its leaves.  xai_tpu splits its fused ``[D, 3D]`` qkv kernel's
    columns contiguously, whose layout is ``[3][heads][hd]``: XLA keeps the
    meaning of any split, a hand-written one cannot, so the port splits
    q, k and v each by head (:func:`shard_param`)."""
    spec = {}
    for name, _ in model.named_parameters():
        block, _, leaf = name.partition(".")
        spec[name] = _SPLIT.get(leaf) if block.startswith("block") else None
    return spec


def shard_param(name: str, t: torch.Tensor, dim: Optional[int], rank: int,
                ranks: int) -> torch.Tensor:
    """Rank ``rank``'s part of parameter ``name`` of ``ranks``, split along
    ``dim`` (None: the whole tensor).  The fused qkv rows are ``[3][heads]
    [hd]``: each rank takes its heads of q, of k and of v."""
    if dim is None:
        return t
    if ".attn.qkv." in name:
        return t.unflatten(0, (3, -1)).chunk(ranks, 1)[rank].flatten(0, 1)
    return t.chunk(ranks, dim)[rank]


class TensorParallelViT(nn.Module):
    """A port ``VisionTransformer`` split over one data row's ``devices``,
    rank ``r`` on ``devices[r]`` (entries may repeat).  The patch
    embedding, the LayerNorms and the head stay whole on ``devices[0]``;
    each block's qkv / fc1 rows and proj / fc2 columns split by
    :func:`vit_param_spec`.  A block makes two reductions, after proj and
    after fc2: the ranks' partial products summed in rank order on
    ``devices[0]``, the bias added once, the sum sent back out as the next
    input.  Takes and returns tensors on ``devices[0]``."""

    def __init__(self, model: nn.Module, devices: Sequence,
                 param_spec: Optional[dict] = None):
        super().__init__()
        if not hasattr(model, "blocks") or not hasattr(model, "cfg"):
            raise TypeError(f"TensorParallelViT: need a VisionTransformer, "
                            f"got {type(model).__name__}")
        want = vit_param_spec(model)
        if param_spec is not None and param_spec != want:
            raise ValueError("TensorParallelViT: runs vit_param_spec's "
                             "split only")
        self.devices = [canonical_device(d) for d in devices]
        ranks = len(self.devices)
        cfg = model.cfg
        hidden = model.block0.mlp_fc1.out_features
        if cfg.num_heads % ranks or hidden % ranks:
            raise ValueError(
                f"TensorParallelViT: {cfg.num_heads} heads and {hidden} MLP "
                f"units do not split over {ranks} ranks")
        self.cfg = cfg
        self.base = replicate(Mesh([self.devices[:1]]), model)[
            self.devices[0]]
        params = dict(model.named_parameters())
        # per rank, per block: the rank's slices, contiguous on its device
        self.shards = [[{
            leaf: shard_param(f"block{i}.{leaf}", params[f"block{i}.{leaf}"]
                              .detach(), dim, r, ranks)
            .contiguous().to(dev) for leaf, dim in _SPLIT.items()}
            for i in range(cfg.depth)] for r, dev in enumerate(self.devices)]

    def _reduce(self, parts: list, bias: torch.Tensor) -> torch.Tensor:
        out = parts[0]
        for p in parts[1:]:
            out = out + p.to(self.devices[0])
        return out + bias

    def _attention(self, i: int, z: torch.Tensor) -> torch.Tensor:
        b, n, c = z.shape
        hd = c // self.cfg.num_heads
        heads = self.cfg.num_heads // len(self.devices)
        parts = []
        for dev, shard in zip(self.devices, self.shards):
            w = shard[i]
            qkv = F.linear(z.to(dev), w["attn.qkv.weight"],
                           w["attn.qkv.bias"]).view(b, n, 3, heads, hd)
            q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
            # the unsharded Attention's order: scale after the product
            attn = torch.softmax((q @ k.transpose(-2, -1)) * hd ** -0.5, -1)
            out = (attn @ v).transpose(1, 2).reshape(b, n, heads * hd)
            parts.append(F.linear(out, w["attn.proj.weight"]))
        return self._reduce(parts, self.base.blocks()[i].attn.proj.bias)

    def _mlp(self, i: int, z: torch.Tensor) -> torch.Tensor:
        parts = []
        for dev, shard in zip(self.devices, self.shards):
            w = shard[i]
            h = F.gelu(F.linear(z.to(dev), w["mlp_fc1.weight"],
                                w["mlp_fc1.bias"]))
            parts.append(F.linear(h, w["mlp_fc2.weight"]))
        return self._reduce(parts, self.base.blocks()[i].mlp_fc2.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.base
        y = m.embed(x)
        for i, block in enumerate(m.blocks()):
            y = y + self._attention(i, block.norm1(y))
            y = y + self._mlp(i, block.norm2(y))
        return m.head(m.norm(y)[:, 0])
