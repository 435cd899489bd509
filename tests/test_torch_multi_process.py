"""xai_tpu_torch's drivers and sweep across two real processes on the CPU.

Two processes join a gloo group on localhost
(``parallel/multi_host.py initialize``) and run the four drivers with
``--shard_images`` and the sweep, on TINY_R with xai_tpu's weights
carried through ``save_params`` / ``load_params``
(``tests/torch_multi_process_runs.py`` lists the runs).  Process 0's
files must be within 1e-4 of the port's single-process run of the same
flags (the sums are float32 and added in another order) and within 2e-3
of xai_tpu's single-process files (TXT 1e-3, as
``tests/test_multi_process.py`` holds xai_tpu's own); process 1 writes
nothing, and both processes return the global scores.  The runs include
an uneven stripe (3 images), one where process 1 scores nothing (1
image), a batched one, and GradientShap, whose baselines and alphas come
from each image's ``(seed, index)`` generator and so do not depend on
the stripe.
"""
import json
import math
import os

import jax
import numpy as np
import pytest

from xai_tpu.runners.common import build_bundle as jax_build_bundle
from xai_tpu.runners.common import save_params
from xai_tpu.runners.evaluate_sanity import randomize_family

import torch_multi_process_runs as R
from test_torch_multi_host import run_two
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

WORKER = r"""
import json, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, "tests")
import torch_multi_process_runs as R
from xai_tpu_torch.parallel import multi_host
from xai_tpu_torch.runners import evaluate_perturbation as ep

rank, port, base, params, rand = (int(sys.argv[1]), sys.argv[2],
                                  *sys.argv[3:6])
multi_host.initialize(f"127.0.0.1:{port}", 2, rank)
R.pin_weights(setattr, "xai_tpu_torch", params, rand)
# count the images each process scores on the perturbation runs
scored = []
battery, batched = ep.run_battery, ep.sharded_battery_scores
ep.run_battery = lambda *a, **k: scored.append(1) or battery(*a, **k)
ep.sharded_battery_scores = lambda bundle, xs, *a, **k: (
    scored.extend([1] * len(xs)) or batched(bundle, xs, *a, **k))
out = {"rank": rank, "returned": {}, "scored": {}}
for label, _, _ in R.RUNS:
    before = len(scored)
    out["returned"][label] = R.run_port(base, label, f"p{rank}", shard=True)
    out["scored"][label] = len(scored) - before
print("RESULT " + json.dumps(out), flush=True)
"""

# images each process scores: kept images striped by kept rank
SCORED = {"pert_uneven": [2, 1], "pert_rank1_empty": [1, 0],
          "pert_batched": [2, 2], "pert_gs": [2, 1]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two processes' runs, the port's single-process runs of the same
    flags ("solo") and xai_tpu's ("jax"); the single-process runs go on
    while the two processes do."""
    base = tmp_path_factory.mktemp("multi_process")
    params = jax_build_bundle("TINY_R", seed=2).params
    params_path = save_params(params, str(base / "tiny_r.npz"))
    # the sanity driver's randomization at --seed 0
    rand_path = save_params(
        randomize_family(params, "cnn", jax.random.PRNGKey(1)),
        str(base / "tiny_r_rand.npz"))
    with run_two(WORKER, str(base), params_path, rand_path,
                 timeout=600) as two, pytest.MonkeyPatch.context() as mp:
        R.pin_weights(mp.setattr, "xai_tpu_torch", params_path, rand_path)
        R.pin_weights(mp.setattr, "xai_tpu", params_path)
        solo = {label: R.run_port(base, label, "solo", shard=False)
                for label, _, _ in R.RUNS}
        ref = R.run_xai_tpu(base)
    return base, two.outs, solo, ref


def _close(got: dict, want: dict, tol: float, what) -> None:
    assert list(sorted(got)) == list(sorted(want)), what
    for k in want:
        assert abs(got[k] - want[k]) < tol, (what, k, got[k], want[k])


LABELS = [r[0] for r in R.RUNS]


@pytest.mark.parametrize("label", LABELS)
def test_rank0_files_match_the_single_process_run(runs, label):
    base = runs[0]
    tag = "shared" if label == "sweep" else "p0"
    for got, want in zip(R.result_files(base, label, tag),
                         R.result_files(base, label, "solo")):
        got_rows, want_rows = R.read_result(got), R.read_result(want)
        assert got_rows and all(math.isfinite(v) for v in got_rows.values())
        _close(got_rows, want_rows, 1e-4, got)


@pytest.mark.parametrize("label", [r[0] for r in R.XAI_TPU_RUNS])
def test_rank0_files_match_xai_tpus_single_process_files(runs, label):
    base = runs[0]
    tag = "shared" if label == "sweep" else "p0"
    for got, want in zip(R.result_files(base, label, tag),
                         R.result_files(base, label, "jax")):
        tol = 2e-3 if got.endswith(".csv") else 1e-3
        _close(R.read_result(got), R.read_result(want), tol, got)


@pytest.mark.parametrize("label", [lb for lb in LABELS if lb != "sweep"])
def test_rank1_writes_nothing_and_both_return_the_global_scores(runs,
                                                                label):
    base, outs, solo, _ = runs
    assert not os.path.exists(R.out_dir(base, label, "p1"))
    for o in outs:
        # the sharded drivers return their sums in sorted key order
        _close(o["returned"][label], solo[label], 1e-4, (o["rank"], label))
    assert outs[0]["returned"][label] == outs[1]["returned"][label]


@pytest.mark.parametrize("label", sorted(SCORED))
def test_each_process_scores_its_stripe(runs, label):
    outs = runs[1]
    assert [o["scored"][label] for o in outs] == SCORED[label]


def test_sweep_stripes_its_runs_into_one_manifest(runs):
    base, outs, solo, _ = runs
    # process 0 takes the grad run, process 1 the ig run
    assert [[r["attr_func"] for r in o["returned"]["sweep"]]
            for o in outs] == [["grad"], ["ig"]]
    with open(os.path.join(R.out_dir(base, "sweep", "shared"),
                           "sweep_manifest.jsonl")) as f:
        manifest = [json.loads(line) for line in f]
    assert sorted((r["attr_func"], r["status"]) for r in manifest) == [
        ("grad", "ok"), ("ig", "ok")]
    for rec in manifest:
        want = [s for s in solo["sweep"]
                if s["attr_func"] == rec["attr_func"]][0]
        _close(rec["scores"], want["scores"], 1e-4, rec["attr_func"])


def test_stochastic_method_is_the_same_striped_and_not(runs):
    """GradientShap draws each image's baselines and alphas from its
    (seed, index) generator, so process 0's CSV is the single-process
    CSV."""
    base = runs[0]
    got = R.read_result(R.result_files(base, "pert_gs", "p0")[0])
    want = R.read_result(R.result_files(base, "pert_gs", "solo")[0])
    _close(got, want, 1e-4, "gs")
    assert np.isfinite(list(got.values())).all()
