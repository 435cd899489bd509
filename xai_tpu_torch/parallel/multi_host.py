"""Multi-process runs: the counterpart of ``xai_tpu/parallel/multi_host.py``
on ``torch.distributed`` with the gloo backend on CPU tensors.

Pattern, as in xai_tpu: the caller starts every process with
:func:`initialize` (the drivers do not call it), each process stripes its
work by :func:`process_index` (per-image generators come from ``(seed,
image index)``, so striping leaves every map as it was), runs its slice
with the normal drivers, and the host score sums meet in
:func:`allreduce_sums` or :func:`allgather_obj`.  The payloads are a
dozen host floats and small objects, so gloo carries them; the model and
the kernels stay on each process's own device (``cuda:<--cuda_num>``).
Two processes may share one card, which NCCL would refuse.

Every function is a no-op in a single process (no process group), and
returns there what xai_tpu's returns.
"""
from __future__ import annotations

import datetime
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# xai_tpu's barrier timeout: processes reach their first collective with
# arbitrary skew (striped jobs build different models)
TIMEOUT_S = 1800.0
# xai_tpu broadcasts the joined key set in a fixed 4096-byte buffer and
# refuses a longer one; the port refuses the same inputs
KEYS_MAX_BYTES = 4096


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the gloo process group at ``tcp://<coordinator_address>``
    (``host:port``) as rank ``process_id`` of ``num_processes``; a no-op
    when ``num_processes`` is None or <= 1."""
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if _group_up() else 0


def process_count() -> int:
    """The number of processes; 1 without a process group."""
    return dist.get_world_size() if _group_up() else 1


def my_shard(items) -> list:
    """Stripe a work list over processes (images, sweep jobs, ...)."""
    return list(items)[process_index()::process_count()]


def barrier() -> None:
    """Wait for every process, under the group's timeout."""
    if process_count() > 1:
        dist.barrier()


def _gather_rows(local: np.ndarray) -> np.ndarray:
    """Every process's float32 row, stacked in rank order."""
    row = torch.from_numpy(np.ascontiguousarray(local, np.float32))
    rows = [torch.empty_like(row) for _ in range(process_count())]
    dist.all_gather(rows, row)
    return np.stack([r.numpy() for r in rows])


def allreduce_sums(scores: dict, extra: float = 0.0):
    """Sum per-process score sums (plus one scalar, e.g. attribution
    seconds) over every process; each returns the same global sums, keyed
    by process 0's keys in sorted order.

    A process that scored nothing passes ``{}`` and adds zeros; a key that
    process 0 lacks raises.  The sums are float32, as xai_tpu's device
    gather without x64 makes them, and added in rank order (a gather, not
    an all_reduce, keeps xai_tpu's order of summation)."""
    if process_count() == 1:
        return dict(scores), float(extra)
    payload = ",".join(sorted(scores)).encode()
    if len(payload) > KEYS_MAX_BYTES:
        raise ValueError(
            f"allreduce_sums key set is {len(payload)} bytes joined; the "
            f"fixed broadcast buffer holds {KEYS_MAX_BYTES}")
    box = [payload]
    dist.broadcast_object_list(box, src=0)
    keys = [k for k in box[0].decode().split(",") if k]
    stray = set(scores) - set(keys)
    if stray:
        raise ValueError(
            f"host {process_index()} has score keys absent on host 0 "
            f"(would be silently dropped from the global sums): "
            f"{sorted(stray)}")
    total = _gather_rows(np.array(
        [float(scores.get(k, 0.0)) for k in keys] + [float(extra)],
        np.float32)).sum(0)
    return ({k: float(total[i]) for i, k in enumerate(keys)},
            float(total[-1]))


def allgather_obj(obj) -> list:
    """Every process's picklable ``obj``, in rank order, exactly: the seg
    drivers' int64 counters and their per-image AP / F1 lists of
    different lengths come back bit for bit."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def allreduce_scores(scores: dict, count: int) -> dict:
    """Global means of per-process (score sums, image count), keyed in
    sorted order; float32 sums in rank order, as :func:`allreduce_sums`."""
    if process_count() == 1:
        return {k: v / max(count, 1) for k, v in scores.items()}
    keys = sorted(scores)
    total = _gather_rows(np.array([scores[k] for k in keys] + [float(count)],
                                  np.float32)).sum(0)
    n = total[-1]
    return {k: float(total[i] / max(n, 1)) for i, k in enumerate(keys)}
