"""The rest of a run on the CPU, with the timed path broken underneath:
``correct`` must come out false for each fault the cells can have, and
true with none.  The runs skip the look for a card (``harness.measure``
on CPU devices) and are held to the limits of the cell named."""
import time

import numpy as np
import pytest
import torch

from portbench import harness

from .helpers import make_spec

CPU = torch.device("cpu")


def _run(spec, cards=1):
    out = harness.measure(spec, 2 ** 31 + 11, 0.0, False, [CPU] * cards,
                          time.perf_counter())
    return out["correct"], out["checks"]


def _half(items, mean):
    """The batch with its second half left out and replaced by the mean
    of the first half."""
    n = len(items) // 2
    return list(items[:n]) + [mean(items[:n])] * (len(items) - n)


@pytest.fixture
def vit_spec(tiny_vit):
    return make_spec("tiny_vit", "rollout_b4", "vit16_rollout_b4")


def test_no_fault_is_correct(vit_spec):
    correct, checks = _run(vit_spec)
    assert correct, checks


def test_attribution_half_batch(vit_spec, monkeypatch):
    from xai_tpu_torch.runners import common
    real = common.batch_attribute

    def broken(*a, **k):
        sals, dt = real(*a, **k)
        return np.stack(_half(sals, lambda s: np.mean(s, 0))), dt
    monkeypatch.setattr(common, "batch_attribute", broken)
    correct, checks = _run(vit_spec)
    assert not correct and checks["map_err"]["value"] > \
        checks["map_err"]["limit"]


def test_battery_half_batch(vit_spec, monkeypatch):
    from xai_tpu_torch.parallel import sharded_battery as sb
    real = sb.sharded_battery_scores

    def broken(*a, **k):
        return _half(real(*a, **k), lambda ds: {
            key: float(np.mean([d[key] for d in ds])) for key in ds[0]})
    monkeypatch.setattr(sb, "sharded_battery_scores", broken)
    correct, checks = _run(vit_spec)
    assert not correct and checks["score_gap"]["value"] > \
        checks["score_gap"]["limit"]


def test_exchange_between_cards_left_out(tiny_vit, monkeypatch):
    """A 16-image step over a 4-way virtual mesh (the harness on four
    cards, 8 of a step's images compared, one of each pair, so every
    shard), every shard's curves replaced by the first shard's to finish:
    the exchange from the other cards left out."""
    from xai_tpu_torch.metrics import curves
    from xai_tpu_torch.parallel.mesh import make_mesh
    from xai_tpu_torch.runners import evaluate_perturbation as ep
    monkeypatch.setattr(ep, "battery_mesh",
                        lambda device, b: make_mesh(devices=[CPU] * 4))
    spec = make_spec("tiny_vit", "rollout_b4", "vit16_rollout_b4",
                     chips=4, pool=32, image_batch=16, check_steps=1,
                     check_per_step=8)
    out = harness.measure(spec, 5, 0.0, True, [CPU] * 4, time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4
    assert set(out["metrics"]) == {"attr_s_per_image", "battery_s_per_image",
                                   "step_mfu_pct"}

    real, first = curves.battery_curves, []

    def broken(*a, **k):
        out = real(*a, **k)
        if not first:
            first.append(out)
        return first[0]
    monkeypatch.setattr(curves, "battery_curves", broken)
    correct, checks = _run(spec, cards=4)
    assert not correct and checks["score_gap"]["value"] > \
        checks["score_gap"]["limit"]


def test_map_altered_where_made(vit_spec, monkeypatch):
    from xai_tpu_torch.runners import common
    real = common.batch_attribute

    def broken(*a, **k):
        sals, dt = real(*a, **k)
        sals = np.array(sals)
        sals[1] = sals[1].T
        return sals, dt
    monkeypatch.setattr(common, "batch_attribute", broken)
    correct, checks = _run(vit_spec)
    assert not correct and checks["map_err"]["value"] > \
        checks["map_err"]["limit"]


def test_score_altered_where_made(vit_spec, monkeypatch):
    from xai_tpu_torch.parallel import sharded_battery as sb
    real = sb.sharded_battery_scores

    def broken(*a, **k):
        out = real(*a, **k)
        out[2] = dict(out[2], MAS_ins=out[2]["MAS_ins"] + 0.01)
        return out
    monkeypatch.setattr(sb, "sharded_battery_scores", broken)
    correct, checks = _run(vit_spec)
    assert not correct and checks["score_gap"]["value"] >= 0.009


def test_target_altered_where_made(vit_spec, monkeypatch):
    from xai_tpu_torch.runners import common
    real = common.image_gates

    def broken(*a, **k):
        target, pred, ok = real(*a, **k)
        return (target + 1) % 1000, pred, ok
    monkeypatch.setattr(common, "image_gates", broken)
    correct, checks = _run(vit_spec)
    assert not correct and checks["pred_gap"]["value"] > \
        checks["pred_gap"]["limit"]


def test_stale_step(vit_spec, monkeypatch):
    """A step that hands back the previous step's answers."""
    from xai_tpu_torch.runners import common
    real, last = common.batch_attribute, []

    def broken(*a, **k):
        out = real(*a, **k)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    monkeypatch.setattr(common, "batch_attribute", broken)
    spec = dict(vit_spec, traffic=dict(vit_spec["traffic"], check_steps=2))
    out = harness.measure(spec, 3, 0.0, False, [CPU], time.perf_counter())
    assert not out["correct"]


def test_ig_half_batch(monkeypatch):
    """The IG path: the batched sweep's second half left out."""
    from xai_tpu_torch.runners import common
    spec = make_spec("tiny_r", "ig_b4", "r101_ig_b4", pool=4)
    real = common.batch_attribute

    def broken(*a, **k):
        sals, dt = real(*a, **k)
        return np.stack(_half(sals, lambda s: np.mean(s, 0))), dt
    monkeypatch.setattr(common, "batch_attribute", broken)
    correct, checks = _run(spec)
    assert not correct and checks["map_err"]["value"] > \
        checks["map_err"]["limit"]
