"""The flagship driver's kept-image step, as
``xai_tpu_torch/runners/evaluate_perturbation.py`` runs it, and its check
against the plain reference.

A step takes the next ``image_batch`` images of the pool and calls the
driver's public functions in the driver's order: ``normalize_input``;
``image_gates(gates=False)`` (the target from the first forward, as
``--synthetic`` / ``--skip_gates`` run: the gates assume trained
weights); the attribution (image by image ``registry.get_attribution``
through ``attr_context``, else ``runners.common.batch_attribute``); the
battery (image by image ``metrics.curves.run_battery(chunk=45)``, else
``parallel.sharded_battery.sharded_battery_scores`` on
``evaluate_perturbation.battery_mesh(device, B)``).  Each returns host
numpy, so a step ends with its device work done.

The check runs after the window, once the program's bundle is freed: on
the images of ``check_steps`` steps drawn from the seed, the reference
(``portbench/reference``) recomputes, from the same pool image and the
same weights made again from the seed, the target's probability, the map
at the program's target, and the 10 scores of the program's map (the
reference reads the program's map only to judge its battery; the map is
judged by itself).  ``compare.py`` turns the two sides into the numbers
that decide ``correct``.
"""
from __future__ import annotations

import gc
import importlib
import sys
import time

import numpy as np
import torch

from .. import reference
from ..images import image_pool
from ..reference import battery as ref_battery
from ..weights import make_weights, stream_seed


def reference_family(cfg: dict):
    return importlib.import_module(f"portbench.reference.{cfg['family']}")


class Cell:
    """One run's program side: build, warm up, step, free."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, devices: list,
                 spans):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.devices, self.spans = devices, spans
        self.batch = traffic["image_batch"]
        self.pool = image_pool(traffic["images"], cfg["img_hw"], seed)
        self.records = []
        self._next = 0

    def setup(self) -> None:
        """The bundle with the benchmark's weights, the blur, the mesh;
        then one step of the cell's own shapes, not recorded."""
        from xai_tpu_torch.runners import common
        from xai_tpu_torch.runners import evaluate_perturbation as ep

        device = self.devices[0]
        t = [time.perf_counter()]
        self.bundle = common.build_bundle(self.cfg["program_model"],
                                          device=device)
        t.append(time.perf_counter())
        weights = make_weights(reference_family(self.cfg).param_spec(
            self.cfg), self.cfg["init"], self.seed, device)
        self.bundle.module.load_state_dict(weights)
        del weights
        t.append(time.perf_counter())
        self.family = self.cfg["program_family"]
        self.blur = common.default_blur()
        self.dtype = common.ATTR_DTYPES[self.traffic["attr_dtype"]]
        self.mesh = (ep.battery_mesh(device, self.batch)
                     if self.batch > 1 else None)
        self.step(record=False)
        t.append(time.perf_counter())
        print("setup_parts_s " + " ".join(
            f"{k}={b - a:.3f}" for k, a, b in zip(
                ("bundle", "weights", "warm_step"), t, t[1:])),
            file=sys.stderr)

    def step(self, record: bool = True) -> int:
        """One kept-image step; returns the images it scored."""
        from xai_tpu_torch.metrics.curves import run_battery
        from xai_tpu_torch.parallel.sharded_battery import \
            sharded_battery_scores
        from xai_tpu_torch.registry import get_attribution
        from xai_tpu_torch.runners import common

        device, attr_func = self.devices[0], self.traffic["attr_func"]
        idx = [(self._next + i) % len(self.pool) for i in range(self.batch)]
        self._next += self.batch
        with self.spans("prep"):
            pend = []
            for i in idx:
                x = common.normalize_input(self.pool[i], self.family, device)
                target, pred, _ = common.image_gates(self.bundle, x,
                                                     self.blur, gates=False)
                pend.append({"x": x, "trans_img": self.pool[i],
                             "name": f"pool{i}", "target": target,
                             "original_pred": pred,
                             "generator": common.image_generator(
                                 self.seed, i, device)})
        if self.batch == 1:
            p = pend[0]
            with self.spans("attr"):
                sals = [get_attribution(self.family, attr_func,
                                        common.attr_context(self.bundle, p,
                                                            self.dtype))]
            with self.spans("battery"):
                scores = [run_battery(self.bundle.apply, p["x"], sals[0],
                                      self.blur, chunk=45,
                                      target=p["target"])]
        else:
            with self.spans("attr"):
                sals, _ = common.batch_attribute(self.bundle, self.family,
                                                 attr_func, pend, self.dtype)
            with self.spans("battery"):
                scores = sharded_battery_scores(
                    self.bundle, torch.stack([p["x"] for p in pend]), sals,
                    self.blur, chunk=45,
                    targets=[p["target"] for p in pend], mesh=self.mesh)
        if record:
            self.records.append([
                {"pool": i, "target": p["target"],
                 "pred": p["original_pred"], "map": np.asarray(s),
                 "scores": sc}
                for i, p, s, sc in zip(idx, pend, sals, scores,
                                       strict=True)])
        return self.batch

    def free(self) -> None:
        """Drop the program's state, so the reference runs in the room
        the program leaves."""
        self.bundle = self.mesh = self.blur = None
        gc.collect()
        for d in self.devices:
            if d.type == "cuda":
                with torch.cuda.device(d):
                    torch.cuda.empty_cache()

    def checked(self) -> list:
        """The program's records the check compares: ``check_steps`` of
        the window's steps, drawn from the seed, and of each
        ``check_per_step`` images (default: all), one drawn from each of
        as many equal runs of the step's images, so that every part of a
        batch (every card's shard) is compared."""
        rng = np.random.default_rng(stream_seed(self.seed, 2))
        k = min(self.traffic["check_steps"], len(self.records))
        per = self.traffic.get("check_per_step", self.batch)
        run = self.batch // per
        out = []
        for i in sorted(rng.choice(len(self.records), size=k,
                                   replace=False)):
            out += [self.records[i][j * run + int(rng.integers(run))]
                    for j in range(per)]
        return out


class Reference:
    """The plain reference of a configuration and traffic mix on one
    device, with the benchmark's weights for ``seed``."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 tf32: bool = False):
        self.cfg, self.traffic, self.device, self.tf32 = (cfg, traffic,
                                                          device, tf32)
        self.fam = reference_family(cfg)
        self.method = importlib.import_module(
            f"portbench.reference.{traffic['attr_func']}")
        self.w = make_weights(self.fam.param_spec(cfg), cfg["init"], seed,
                              device)
        self.mean = torch.tensor(cfg["mean"], device=device)
        self.std = torch.tensor(cfg["std"], device=device)

    def forward(self, x, **kw):
        return self.fam.forward(self.w, self.cfg, x, **kw)

    def input(self, img: np.ndarray) -> torch.Tensor:
        """The normalized ``[3, H, W]`` input of a pool image."""
        x = (torch.as_tensor(img, device=self.device) - self.mean) / self.std
        return x.permute(2, 0, 1).contiguous()

    def probs(self, x: torch.Tensor) -> np.ndarray:
        with reference.precision(self.tf32), torch.no_grad():
            return torch.softmax(self.forward(x[None]), -1)[0].double() \
                .cpu().numpy()

    def attribute(self, x: torch.Tensor, target: int) -> np.ndarray:
        with reference.precision(self.tf32):
            return self.method.attribute(self, x[None], [target],
                                         self.cfg)[0].cpu().numpy()

    def scores(self, x: torch.Tensor, saliency: np.ndarray,
               target: int) -> dict:
        b = self.traffic["battery"]
        with reference.precision(self.tf32):
            return ref_battery.scores(self.forward, x, saliency, target,
                                      b["klen"], b["sigma"])


def reference_records(cfg, traffic, seed, device, pool, sides,
                      own_map: bool = False) -> list:
    """The reference's side of each compared image: its probabilities,
    its map at the judged side's target, and its scores of the judged
    side's map; with ``own_map``, also its scores of its own map
    (``own_scores``: the reference end to end, which ``calibrate.py``
    reads to show how far map error moves the scores)."""
    ref = Reference(cfg, traffic, seed, device)
    out = []
    for s in sides:
        x = ref.input(pool[s["pool"]])
        rec = {"probs": ref.probs(x), "map": ref.attribute(x, s["target"]),
               "scores": ref.scores(x, s["map"], s["target"])}
        if own_map:
            rec["own_scores"] = ref.scores(x, rec["map"], s["target"])
        out.append(rec)
    return out


def control_records(cfg, traffic, seed, device, pool, pools) -> list:
    """The lower-precision control in the program's place: the reference
    with TF32 on, its own target, map and scores, for pool images
    ``pools``."""
    ctl = Reference(cfg, traffic, seed, device, tf32=True)
    out = []
    for i in pools:
        x = ctl.input(pool[i])
        probs = ctl.probs(x)
        target = int(probs.argmax())
        sal = ctl.attribute(x, target)
        out.append({"pool": i, "target": target, "pred": float(probs[target]),
                    "map": sal, "scores": ctl.scores(x, sal, target)})
    return out
