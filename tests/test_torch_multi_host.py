"""xai_tpu_torch.parallel.multi_host against xai_tpu's on the CPU.

In one process every function is a no-op and returns what xai_tpu's
returns on the same inputs.  The refusals of ``allreduce_sums`` (a key
that process 0 lacks, a key set over 4096 bytes) are checked in one
process, with the world size and the key broadcast stood in for, in both
packages: across two real processes the refused rank would leave its
peer waiting in the gather until the timeout.  The collectives
themselves run in two gloo processes on localhost.
"""
import contextlib
import json
import os
import socket
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

from xai_tpu.parallel import multi_host as J

from xai_tpu_torch.parallel import multi_host as T

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCORES = {"MAS_ins": 0.25, "MAS_del": 1.5, "ROAD": -0.125}


def test_single_process_is_a_no_op():
    assert T.process_index() == 0 and T.process_count() == 1
    assert T.initialize() is None and J.initialize() is None
    assert T.initialize("127.0.0.1:1", 1, 0) is None
    assert T.barrier() is None and J.barrier() is None
    items = list(range(7))
    assert T.my_shard(items) == J.my_shard(items) == items
    assert T.allreduce_sums(SCORES, 2.5) == J.allreduce_sums(SCORES, 2.5)
    assert T.allreduce_sums({}) == J.allreduce_sums({}) == ({}, 0.0)
    obj = {"inter": np.array([2**62, 3], np.int64), "ap": [0.5]}
    got, want = T.allgather_obj(obj), J.allgather_obj(obj)
    assert len(got) == len(want) == 1 and got[0] is obj and want[0] is obj
    assert T.allreduce_scores(SCORES, 4) == J.allreduce_scores(SCORES, 4)
    assert T.allreduce_scores(SCORES, 0) == J.allreduce_scores(SCORES, 0)


def _as_rank_1_of_2(monkeypatch, rank0_keys: str):
    """Both packages' allreduce_sums see two processes, this one rank 1,
    and receive ``rank0_keys`` as process 0's broadcast key set."""
    from jax.experimental import multihost_utils

    monkeypatch.setattr(T, "process_count", lambda: 2)
    monkeypatch.setattr(T, "process_index", lambda: 1)

    def torch_broadcast(box, src):
        assert src == 0
        box[0] = rank0_keys.encode()

    monkeypatch.setattr(T.dist, "broadcast_object_list", torch_broadcast)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    monkeypatch.setattr(
        multihost_utils, "broadcast_one_to_all",
        lambda buf: np.frombuffer(rank0_keys.encode().ljust(4096),
                                  np.uint8))


def _refusal(fn, *args) -> str:
    with pytest.raises(ValueError) as e:
        fn(*args)
    return str(e.value)


def test_stray_key_is_refused_as_xai_tpu_refuses_it(monkeypatch):
    _as_rank_1_of_2(monkeypatch, "MAS_del,MAS_ins")
    msg = _refusal(T.allreduce_sums, SCORES, 1.0)
    assert "absent on host 0" in msg and "['ROAD']" in msg
    assert msg == _refusal(J.allreduce_sums, SCORES, 1.0)


def test_key_set_over_4096_bytes_is_refused_as_xai_tpu_refuses_it(
        monkeypatch):
    _as_rank_1_of_2(monkeypatch, "")
    big = {f"score_{i:04d}": 0.0 for i in range(400)}
    msg = _refusal(T.allreduce_sums, big)
    assert "holds 4096" in msg
    assert msg == _refusal(J.allreduce_sums, big)
    # a key set of 4096 bytes joined still fits, in both; the gathers
    # stand in for a peer with the same sums
    from jax.experimental import multihost_utils

    _as_rank_1_of_2(monkeypatch, "k" * 4096)
    monkeypatch.setattr(T, "_gather_rows",
                        lambda row: np.stack([row, row]))
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda row: np.stack([row, row]))
    fits = {"k" * 4096: 1.5}
    assert (T.allreduce_sums(fits, 0.25) == J.allreduce_sums(fits, 0.25)
            == ({"k" * 4096: 3.0}, 0.5))


WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from xai_tpu_torch.parallel import multi_host as M

rank, port = int(sys.argv[1]), sys.argv[2]
M.initialize(f"127.0.0.1:{port}", 2, rank)
out = {"rank": M.process_index(), "count": M.process_count(),
       "shard": M.my_shard(list(range(5)))}
M.barrier()
# exact objects: int64 counters above 2**53 and lists of unequal length
mine = {"inter": np.array([2**53 + 1 + rank, 2**62 + rank], np.int64),
        "correct": 2**60 + 3 * rank,
        "ap": [0.1 * i for i in range(rank + 2)]}
parts = M.allgather_obj(mine)
out["gather"] = [{"inter": [int(v) for v in p["inter"]],
                  "inter_dtype": str(p["inter"].dtype),
                  "correct": p["correct"], "ap": p["ap"]} for p in parts]
# float32 sums: 1e8 + 1 is not a float32, so the float32 path shows
sums = {"MAS_ins": 0.1 + rank, "MAS_del": 1e8 + 1.0 + rank}
out["sums"] = M.allreduce_sums(sums, 0.5 + rank)
# an empty rank pads with zeros
out["padded"] = M.allreduce_sums(sums if rank == 0 else {}, 1.0)
out["means"] = M.allreduce_scores(sums, 3 - rank)
print("RESULT " + json.dumps(out), flush=True)
"""


@contextlib.contextmanager
def run_two(script: str, *args, timeout: int = 120):
    """Start ``script`` as ranks 0 and 1 of a gloo group on a free
    localhost port (``OMP_NUM_THREADS=1``); the body runs while they do.
    On leaving, each must exit 0 within ``timeout`` s, and ``.outs``
    holds each rank's ``RESULT`` JSON; a process left is killed."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(rank), str(port), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=REPO)
        for rank in (0, 1)]
    two = types.SimpleNamespace(outs=[])
    try:
        yield two
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err.decode()[-3000:]
            line = [ln for ln in out.decode().splitlines()
                    if ln.startswith("RESULT ")][0]
            two.outs.append(json.loads(line[len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def test_two_processes_gather_and_sum():
    with run_two(WORKER) as two:
        pass
    outs = two.outs
    assert [o["rank"] for o in outs] == [0, 1]
    assert all(o["count"] == 2 for o in outs)
    assert outs[0]["shard"] == [0, 2, 4] and outs[1]["shard"] == [1, 3]
    want_gather = [{"inter": [2**53 + 1 + r, 2**62 + r],
                    "inter_dtype": "int64", "correct": 2**60 + 3 * r,
                    "ap": [0.1 * i for i in range(r + 2)]} for r in (0, 1)]
    for o in outs:
        assert o["gather"] == want_gather
    # the same sums on both ranks, float32 in rank order
    assert outs[0]["sums"] == outs[1]["sums"]
    f32 = np.array([[0.1 + r, 1e8 + 1.0 + r, 0.5 + r] for r in (0, 1)],
                   np.float32).sum(0)
    sums, extra = outs[0]["sums"]
    assert sums == {"MAS_del": float(f32[1]), "MAS_ins": float(f32[0])}
    assert list(sums) == ["MAS_del", "MAS_ins"]
    assert extra == float(f32[2])
    assert sums["MAS_del"] != 2e8 + 3.0          # float32, not float64
    for o in outs:
        assert o["padded"] == [{"MAS_del": float(np.float32(1e8 + 1.0)),
                                "MAS_ins": float(np.float32(0.1))}, 2.0]
        n = np.float32(5)
        assert o["means"] == {"MAS_del": float(f32[1] / n),
                              "MAS_ins": float(f32[0] / n)}
