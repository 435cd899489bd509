"""The driver runs of ``tests/test_torch_multi_process.py``.

Each run is (label, driver, flags) on TINY_R.  ``run_port`` drives one
through the port's four drivers or its sweep; the two-process workers
run each with ``--shard_images`` (the sweep stripes its runs without
it), the test process without, and ``run_xai_tpu`` runs xai_tpu's
drivers on the same flags for the reference files.  ``pin_weights``
makes every driver build TINY_R from one ``.npz`` of xai_tpu's weights,
the sweep's runs (which take no ``--params_path``) among them, and
gives the sanity driver xai_tpu's randomized weights.  This module imports nothing of xai_tpu;
``run_xai_tpu`` imports it when called.
"""
import copy
import csv
import os
import re

RUNS = [
    # three kept images: two on process 0, one on process 1
    ("pert_uneven", "pert", ["--attr_func", "ig", "--synthetic", "3",
                             "--image_count", "3000"]),
    # one kept image: process 1 scores nothing and adds zeros
    ("pert_rank1_empty", "pert", ["--attr_func", "ig", "--synthetic", "1",
                                  "--image_count", "1000"]),
    # one full batch of two on each process
    ("pert_batched", "pert", ["--attr_func", "ig", "--image_batch", "2",
                              "--synthetic", "4", "--image_count", "4000"]),
    # a stochastic method: GradientShap's baselines and alphas come from
    # each image's (seed, index) generator
    ("pert_gs", "pert", ["--attr_func", "gs", "--synthetic", "3",
                         "--image_count", "3000"]),
    ("sanity", "sanity", ["--attr_func", "ig", "--synthetic", "3",
                          "--image_count", "3"]),
    ("seg", "seg", ["--attr_func", "ig", "--synthetic", "3"]),
    ("seg_eval", "seg_eval", ["--method", "grad", "--synthetic", "3",
                              "--acc_cutoff", "0"]),
    ("sweep", "sweep", ["--drivers", "pert", "--models", "TINY_R",
                        "--methods", "grad,ig", "--synthetic", "2",
                        "--image_count", "2"]),
]

# the runs whose maps xai_tpu's drivers draw alike (gs draws from JAX's
# generator there)
XAI_TPU_RUNS = [r for r in RUNS if r[0] != "pert_gs"]

RUNTIME_ROWS = ("Attr Avg Runtime", "Total Runtime")


def _drivers(pkg):
    """{driver: (module, entry name)} of xai_tpu or xai_tpu_torch."""
    import importlib

    runners = importlib.import_module(f"{pkg}.runners")
    mods = {name: importlib.import_module(f"{runners.__name__}.{name}")
            for name in ("evaluate_perturbation", "evaluate_sanity",
                         "evaluate_imagenet_seg", "imagenet_seg_eval",
                         "sweep")}
    return {"pert": (mods["evaluate_perturbation"], "evaluate_perturbation"),
            "sanity": (mods["evaluate_sanity"], "evaluate_sanity"),
            "seg": (mods["evaluate_imagenet_seg"], "evaluate_imagenet_seg"),
            "seg_eval": (mods["imagenet_seg_eval"], "run"),
            "sweep": (mods["sweep"], "run_sweep")}


def pin_weights(set_attr, pkg: str, params_path: str, rand_path=None):
    """Every driver of ``pkg`` builds its model from ``params_path``;
    the port's sanity driver randomizes to ``rand_path`` (xai_tpu's
    randomized weights; xai_tpu's draws them itself at the same seed).
    ``set_attr``: ``setattr``, or a monkeypatch's."""
    for mod, _ in list(_drivers(pkg).values())[:4]:
        build = mod.build_bundle

        def pinned(name, params_path_=None, *args, _build=build, **kwargs):
            return _build(name, params_path_ or params_path, *args,
                          **kwargs)

        set_attr(mod, "build_bundle", pinned)
    if rand_path is not None:
        from xai_tpu_torch.convert.from_jax import load_params
        from xai_tpu_torch.models.common import ModelBundle

        def randomize(bundle, family, generator):
            module = copy.deepcopy(bundle.module)
            module.load_state_dict(load_params(rand_path))
            return ModelBundle(bundle.meta, module)

        set_attr(_drivers(pkg)["sanity"][0], "randomize_family", randomize)


def out_dir(base, label: str, tag: str) -> str:
    return os.path.join(str(base), f"{label}_{tag}")


def _parse(mod, driver, flags, d):
    model = [] if driver == "sweep" else ["--model", "TINY_R"]
    return mod.build_parser().parse_args(model + flags
                                         + ["--output_dir", d])


def run_port(base, label: str, tag: str, shard: bool, device="cpu"):
    """Run ``label`` of RUNS through the port into
    ``<base>/<label>_<tag>``, with ``--shard_images`` under ``shard`` (the
    sweep's two processes share ``<base>/sweep_shared``); returns what the
    driver returned."""
    driver, flags = {r[0]: r[1:] for r in RUNS}[label]
    mod, entry = _drivers("xai_tpu_torch")[driver]
    if shard and driver == "sweep":
        tag = "shared"
    elif shard:
        flags = flags + ["--shard_images"]
    return getattr(mod, entry)(
        _parse(mod, driver, flags, out_dir(base, label, tag)), device=device)


def run_xai_tpu(base, tag: str = "jax") -> dict:
    out = {}
    for label, driver, flags in XAI_TPU_RUNS:
        mod, entry = _drivers("xai_tpu")[driver]
        out[label] = getattr(mod, entry)(
            _parse(mod, driver, flags, out_dir(base, label, tag)))
    return out


def result_files(base, label: str, tag: str) -> list:
    """The result files a run of ``label`` writes under its directory."""
    d = out_dir(base, label, tag)
    driver, flags = {r[0]: r[1:] for r in RUNS}[label]
    if driver == "sweep":
        return [os.path.join(d, "TINY_R", f"{m}_2_images.csv")
                for m in ("grad", "ig")]
    if driver == "seg_eval":
        return [os.path.join(d, "TINY_R_grad.txt")]
    attr = flags[flags.index("--attr_func") + 1]
    count = (flags[flags.index("--image_count") + 1]
             if "--image_count" in flags else "0")
    name = f"{attr}_{count}_images" + (".csv" if driver != "seg" else "")
    return [os.path.join(d, "TINY_R", name)]


def read_result(path: str) -> dict:
    """A driver's CSV or TXT as {row: number}, runtime rows left out."""
    with open(path) as f:
        if path.endswith(".csv"):
            return {r[0]: float(r[1]) for r in csv.reader(f)
                    if r and r[0] not in RUNTIME_ROWS}
        return {line.split(":")[0]: float(re.sub(r"[ %\n]", "",
                                                 line.split(":")[1]))
                for line in f}
