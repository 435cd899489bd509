"""The in-process mesh of xai_tpu_torch against xai_tpu's on its 8-device
CPU mesh (conftest.py).

The port's virtual mesh repeats the CPU device; xai_tpu's mesh is its 8
virtual CPU devices.  The model is the multi-chip dry run's ViT
(``__graft_entry__.py dryrun_multichip``: patch 8, 32 wide, 2 blocks, 4
heads, MLP ratio 4, 16 classes, 32 px), its params redrawn so that every
bias counts (a tensor-parallel bias added more than once would show),
carried by ``save_params`` -> ``load_params``.  Tolerances: logits and the
eval step 1e-5 (relative for the logits), the train step's loss and
calibration 1e-5, batteries 2e-3 against xai_tpu and 2e-5 against the
port's one-device battery (``tests/test_sharded_battery.py``), the
driver's CSV 2e-3 against xai_tpu and 1e-6 against the port's
one-device file.
"""
import copy
import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from xai_tpu.models import vit as jvit
from xai_tpu.ops.blur import make_blur_fn as jax_make_blur_fn
from xai_tpu.parallel import mesh as JM
from xai_tpu.parallel import sharded_battery as JSB
from xai_tpu.parallel import sharded_eval as JSE
from xai_tpu.runners import evaluate_perturbation as JD
from xai_tpu.runners.common import build_bundle as jax_build_bundle
from xai_tpu.runners.common import save_params

from xai_tpu_torch.metrics import curves as TC
from xai_tpu_torch.models import clip as tclip
from xai_tpu_torch.models.common import ModelMeta
from xai_tpu_torch.ops.blur import make_blur_fn
from xai_tpu_torch.parallel import mesh as TM
from xai_tpu_torch.parallel import multi_host
from xai_tpu_torch.parallel import sharded_battery as TSB
from xai_tpu_torch.parallel import sharded_eval as TSE
from xai_tpu_torch.runners import evaluate_perturbation as TD

from test_torch_clip import CLIP_TINY
from test_torch_vit import close, nchw, redraw, tiny_vit_twins
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

# the dry run's ViT (__graft_entry__.py dryrun_multichip)
DRYRUN = dict(patch=8, embed_dim=32, depth=2, num_heads=4, mlp_ratio=4.0,
              num_classes=16, img_hw=32)
CPUS = [torch.device("cpu")] * 8
MESHES = [(8, 1), (4, 2)]       # (data, model)


def cpu_mesh(n, model_axis=1):
    return TM.make_mesh(n, model_axis, devices=CPUS)


def jax_spec(params, model_axis):
    return JM.vit_param_spec(params) if model_axis > 1 else None


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    model = jvit.VisionTransformer(jvit.ViTConfig(**DRYRUN))
    params = redraw(model.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 3)))["params"],
                    np.random.RandomState(0))
    jb, tb = tiny_vit_twins(
        str(tmp_path_factory.mktemp("params") / "vit.npz"), params, DRYRUN)
    rs = np.random.RandomState(1)
    x = rs.randn(8, 32, 32, 3).astype(np.float32)
    targets = rs.randint(0, 16, size=8)
    return jb, tb, x, targets


@pytest.mark.parametrize("n,model_axis", [(None, 1), (8, 1), (8, 2), (4, 2),
                                          (8, 4), (2, 1), (6, 3)])
def test_make_mesh_shapes_are_xai_tpus(cpu_devices, n, model_axis):
    got = TM.make_mesh(n, model_axis, devices=CPUS)
    ref = JM.make_mesh(n, model_axis)
    assert got.shape == dict(ref.shape)
    assert tuple(got.axis_names) == tuple(ref.axis_names)
    assert got.size == ref.devices.size
    assert all(d == torch.device("cpu") for d in got.distinct())


@pytest.mark.parametrize("n,model_axis,match", [
    (16, 1, "make_mesh.*16 devices.*exposes only 8"),
    (8, 3, "not divisible")], ids=["too_many", "not_divisible"])
def test_make_mesh_errors_are_xai_tpus(cpu_devices, n, model_axis, match):
    with pytest.raises(ValueError, match=match):
        JM.make_mesh(n, model_axis)
    with pytest.raises(ValueError, match=match):
        TM.make_mesh(n, model_axis, devices=CPUS)


def test_make_mesh_defaults_to_cuda_without_a_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.make_mesh(1)


@pytest.mark.parametrize("b", [8, 6, 5, 3])
def test_shard_batch_is_tensor_split(b):
    """Contiguous ragged shards over the data rows, empty ones skipped:
    B=6 over 4 rows is 2/2/1/1, B=3 fills rows 0-2."""
    mesh = cpu_mesh(4)
    x = torch.arange(b * 2).view(b, 2)
    got = TM.shard_batch(mesh, x)
    want = [s for s in torch.tensor_split(x, 4) if s.shape[0]]
    assert [r for r, _ in got] == list(range(len(want)))
    assert all(torch.equal(g, w) for (_, g), w in zip(got, want))


def test_replicate_reuses_on_its_device_and_copies_elsewhere(twins):
    _, tb, _, _ = twins
    mesh = TM.Mesh([[torch.device("cpu")], [torch.device("meta")]])
    for obj in (tb.module, tb):
        reps = TM.replicate(mesh, obj)
        assert list(reps) == [torch.device("cpu"), torch.device("meta")]
        assert reps[torch.device("cpu")] is obj
        moved = reps[torch.device("meta")]
        assert moved is not obj and TM._device_of(moved).type == "meta"
    # a bundle keeps its replica: a driver's flushes copy it once
    assert TM.replicate(mesh, tb)[torch.device("meta")] is moved
    assert TM.replicate(cpu_mesh(8), tb) == {torch.device("cpu"): tb}


def test_clip_bundle_replica_carries_its_text_table():
    module = tclip.CLIP(tclip.CLIPConfig(**CLIP_TINY))
    tb = tclip.CLIPBundle(ModelMeta(name="c", family="clip", img_hw=32),
                          module, torch.randn(10, CLIP_TINY["embed_dim"]),
                          torch.zeros(10, 8, dtype=torch.int64))
    assert tb.to("cpu") is tb
    moved = tb.to("meta")
    assert moved.device.type == "meta"
    assert moved.text_embeddings.device.type == "meta"
    assert moved.text_tokens.device.type == "meta"
    assert tb.text_embeddings.device.type == "cpu"


def _jax_split_leaves(params) -> dict:
    """xai_tpu's vit_param_spec: port name -> the torch dim its split
    axis is (a kernel's columns are torch's dim 0)."""
    out = {}
    spec = JM.vit_param_spec(params)
    for path, s in jax.tree_util.tree_flatten_with_path(spec)[0]:
        if s == P():
            continue
        keys = [str(p.key) for p in path]
        leaf = "weight" if keys[-1] == "kernel" else keys[-1]
        axis = list(s).index("model")
        out[".".join(keys[:-1] + [leaf])] = 1 - axis if leaf == "weight" \
            else 0
    return out


def test_vit_param_spec_splits_xai_tpus_leaves(twins):
    jb, tb, _, _ = twins
    spec = TM.vit_param_spec(tb.module)
    assert set(spec) == set(dict(tb.module.named_parameters()))
    assert {k: v for k, v in spec.items() if v is not None} == \
        _jax_split_leaves(jb.params)


@pytest.mark.parametrize("ranks", [2, 4])
def test_qkv_splits_by_head(twins, ranks):
    """Each rank takes its heads of q, of k and of v (xai_tpu's contiguous
    column split would give rank 0 all of q at two ranks), and proj's
    columns of the same heads."""
    _, tb, _, _ = twins
    blk = tb.module.block0.attn
    d, h = 32, 4
    per = h // ranks
    for r in range(ranks):
        heads = slice(r * per, (r + 1) * per)
        got = TM.shard_param("block0.attn.qkv.weight", blk.qkv.weight, 0, r,
                             ranks)
        want = blk.qkv.weight.view(3, h, d // h, d)[:, heads].reshape(-1, d)
        assert torch.equal(got, want)
        got_b = TM.shard_param("block0.attn.qkv.bias", blk.qkv.bias, 0, r,
                               ranks)
        assert torch.equal(got_b, blk.qkv.bias.view(3, h, d // h)[:, heads]
                           .reshape(-1))
        got_p = TM.shard_param("block0.attn.proj.weight", blk.proj.weight, 1,
                               r, ranks)
        assert torch.equal(got_p, blk.proj.weight.view(d, h, d // h)
                           [:, heads].reshape(d, -1))
    if ranks == 2:
        contiguous = blk.qkv.weight.chunk(2, 0)[0]
        assert not torch.equal(contiguous, TM.shard_param(
            "block0.attn.qkv.weight", blk.qkv.weight, 0, 0, 2))


@pytest.mark.parametrize("ranks", [2, 4])
def test_tensor_parallel_vit_logits(twins, ranks):
    jb, tb, x, _ = twins
    tp = TM.TensorParallelViT(tb.module, CPUS[:ranks],
                              TM.vit_param_spec(tb.module))
    with torch.no_grad():
        got = tp(nchw(x))
        whole = tb.module(nchw(x))
    close(got, whole, 1e-5)
    close(got, jb.apply(jb.params, jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("bad", ["heads", "spec", "model"])
def test_tensor_parallel_vit_refuses(twins, bad):
    _, tb, _, _ = twins
    if bad == "heads":            # 4 heads and 128 units over 3 ranks
        with pytest.raises(ValueError, match="do not split"):
            TM.TensorParallelViT(tb.module, CPUS[:3])
    elif bad == "spec":
        spec = dict(TM.vit_param_spec(tb.module), **{"head.weight": 0})
        with pytest.raises(ValueError, match="vit_param_spec"):
            TM.TensorParallelViT(tb.module, CPUS[:2], spec)
    else:
        with pytest.raises(TypeError, match="VisionTransformer"):
            TM.TensorParallelViT(torch.nn.Linear(2, 2), CPUS[:2])


def _jax_inputs(mesh, jb, x, targets, model_axis):
    spec = jax_spec(jb.params, model_axis)
    params = jb.params if spec is None else jax.device_put(
        jb.params, jax.tree.map(lambda s: NamedSharding(mesh, s), spec))
    data = NamedSharding(mesh, P("data"))
    return (spec, params, jax.device_put(jnp.asarray(x), data),
            jax.device_put(jnp.asarray(targets, jnp.int32), data))


def _apply(jb):
    return lambda p, xb: jb.apply(p, xb)


@pytest.mark.parametrize("data,model_axis", MESHES)
def test_sharded_eval_step_matches_xai_tpu(cpu_devices, twins, data,
                                           model_axis):
    jb, tb, x, targets = twins
    jmesh = JM.make_mesh(8, model_axis)
    spec, params, xs, ts = _jax_inputs(jmesh, jb, x, targets, model_axis)
    ref = JSE.sharded_eval_step(_apply(jb), jmesh, param_spec=spec)(
        params, xs, ts)
    tspec = TM.vit_param_spec(tb.module) if model_axis > 1 else None
    got = TSE.sharded_eval_step(tb.module, cpu_mesh(8, model_axis), tspec)(
        nchw(x), torch.from_numpy(targets))
    assert set(got) == set(ref) == {"mean_target_prob", "accuracy"}
    for k in ref:
        assert got[k].shape == ()
        assert abs(float(got[k]) - float(ref[k])) < 1e-5, (k, got[k], ref[k])


# (dtype, the bias the steps start from).  From init_fn's calibration
# (bias 0) the min-max makes the loss invariant to scale but for the
# 1e-8 in its denominator: d loss / d scale is ~1e-9, as small as float32
# rounding, and Adam's first step (g / (|g| + 1e-8)) turns it into a
# step of up to lr in either direction in either package.  So init_fn's
# steps are held in float64, and float32's from a bias of 0.1, where the
# scale's gradient is not a rounding residue.
TRAIN_CASES = [(d, m, dt) for d, m in MESHES for dt in ("f64", "f32")]


@pytest.mark.parametrize("data,model_axis,dtype", TRAIN_CASES)
def test_sharded_train_step_matches_xai_tpu(cpu_devices, twins, data,
                                            model_axis, dtype):
    """Three MAS-calibration steps: the loss of each and the calibration
    after each."""
    jb, tb, x, targets = twins
    f64 = dtype == "f64"
    module = copy.deepcopy(tb.module).double() if f64 else tb.module
    xt = nchw(x).double() if f64 else nchw(x)
    tspec = TM.vit_param_spec(module) if model_axis > 1 else None
    step, init = TSE.make_sharded_train_step(module, cpu_mesh(8, model_axis),
                                             tspec)
    calib, opt = init()
    assert {k: float(v) for k, v in calib.items()} == {"scale": 1.0,
                                                       "bias": 0.0}
    if not f64:
        calib["bias"] = torch.tensor(0.1)
    with jax.enable_x64(f64):
        jmesh = JM.make_mesh(8, model_axis)
        jb64 = jb if not f64 else dataclasses.replace(
            jb, params=jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                    jb.params))
        spec, params, xs, ts = _jax_inputs(
            jmesh, jb64, x.astype(np.float64) if f64 else x, targets,
            model_axis)
        jstep, jinit = JSE.make_sharded_train_step(_apply(jb64), jmesh,
                                                   param_spec=spec)
        jcalib, jopt = jinit()
        if not f64:
            jcalib = dict(jcalib, bias=jnp.full((), 0.1, jnp.float32))
        repl = NamedSharding(jmesh, P())
        jcalib, jopt = jax.device_put(jcalib, repl), jax.device_put(jopt,
                                                                    repl)
        for _ in range(3):
            jcalib, jopt, jloss = jstep(params, jcalib, jopt, xs, ts)
            calib, opt, loss = step(calib, opt, xt,
                                    torch.from_numpy(targets))
            assert abs(float(loss) - float(jloss)) < 1e-5, (loss, jloss)
            for k in ("scale", "bias"):
                assert abs(float(calib[k]) - float(jcalib[k])) < 1e-5, \
                    (k, calib[k], jcalib[k])
    assert float(calib["scale"]) != 1.0         # the steps moved it


BATTERIES = [(8, 1, 8, False), (8, 1, 5, True), (4, 2, 5, True)]


@pytest.mark.parametrize("data,model_axis,b,explicit", BATTERIES,
                         ids=["8x1-B8-argmax", "8x1-B5-targets",
                              "4x2-tp-B5-targets"])
def test_sharded_battery_matches_xai_tpu(cpu_devices, twins, data,
                                         model_axis, b, explicit):
    jb, tb, x, targets = twins
    x = x[:b]
    sals = np.abs(np.random.RandomState(2).randn(b, 32, 32)).astype(
        np.float32)
    tgt = targets[:b] if explicit else None
    jmesh = JM.make_mesh(8, model_axis)
    spec = jax_spec(jb.params, model_axis)
    ref = JSB.sharded_battery_scores(jb, jmesh, x, sals,
                                     jax_make_blur_fn(31, 31.0), chunk=45,
                                     param_spec=spec, targets=tgt)
    tspec = TM.vit_param_spec(tb.module) if model_axis > 1 else None
    mesh = cpu_mesh(8, model_axis)
    got = TSB.sharded_battery_scores(tb, torch.from_numpy(x), sals,
                                     make_blur_fn(31, 31.0), chunk=45,
                                     targets=tgt, mesh=mesh,
                                     param_spec=tspec)
    one = TC.battery_scores(tb.apply, torch.from_numpy(x), sals,
                            make_blur_fn(31, 31.0), chunk=45, targets=tgt)
    assert len(got) == len(ref) == len(one) == b
    for g, r, o in zip(got, ref, one):
        assert list(g) == list(r)
        for k in r:
            assert abs(g[k] - r[k]) < 2e-3, (k, g[k], r[k])
            assert abs(g[k] - o[k]) < 2e-5, (k, g[k], o[k])


def test_one_by_one_mesh_takes_the_one_device_battery(twins, monkeypatch):
    """No mesh, or a 1x1 one: the whole batch is one shard, with the
    one-device battery's blur and reveal calls and its scores bit for
    bit."""
    _, tb, x, targets = twins
    sals = np.abs(np.random.RandomState(3).randn(2, 32, 32)).astype(
        np.float32)
    calls = {"blur": 0, "reveal": 0, "shards": []}
    blur = make_blur_fn(31, 31.0)
    reveal, curves_of = TC.reveal_batch, TC.battery_curves

    def counted_blur(*a, **k):
        calls["blur"] += 1
        return blur(*a, **k)

    def counted_reveal(*a, **k):
        calls["reveal"] += 1
        return reveal(*a, **k)

    def counted_curves(apply_fn, blur_fn, xs, *a, **k):
        calls["shards"].append(xs.shape[0])
        return curves_of(apply_fn, blur_fn, xs, *a, **k)

    monkeypatch.setattr(TC, "reveal_batch", counted_reveal)
    monkeypatch.setattr(TC, "battery_curves", counted_curves)
    xs = torch.from_numpy(x[:2])
    want = TC.battery_scores(tb.apply, xs, sals, counted_blur, chunk=45,
                             targets=targets[:2])
    one = dict(calls, shards=[2])
    for mesh in (None, cpu_mesh(1)):
        calls.update(blur=0, reveal=0, shards=[])
        got = TSB.sharded_battery_scores(tb, xs, sals, counted_blur, 45,
                                         targets[:2], mesh=mesh)
        assert calls == one
        assert got == want


def test_battery_mesh_puts_the_bundles_card_first(monkeypatch):
    """In one process every visible card, ``--cuda_num``'s first, when the
    batch gives each card two images, else the process's card alone; under
    a process group of two, the process's card alone; on the CPU, 1x1."""
    assert TD.battery_mesh(torch.device("cpu"), 8).devices == \
        cpu_mesh(1).devices
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    alone = ((torch.device("cuda", 1),),)
    got = TD.battery_mesh(torch.device("cuda", 1), 6)
    assert got.devices == tuple((torch.device("cuda", i),) for i in
                                (1, 0, 2))
    assert TD.battery_mesh(torch.device("cuda", 1), 5).devices == alone
    monkeypatch.setattr(multi_host, "process_count", lambda: 2)
    assert TD.battery_mesh(torch.device("cuda", 1), 6).devices == alone


def _csv(path) -> dict:
    with open(path) as f:
        return {r[0]: float(r[1]) for r in csv.reader(f)
                if r and r[0] not in ("Attr Avg Runtime", "Total Runtime")}


def test_batched_driver_over_a_mesh(cpu_devices, tmp_path, monkeypatch):
    """evaluate_perturbation --image_batch 4 on TINY_R: the port over a
    virtual 4x1 mesh (four shards of one image), xai_tpu over its 8
    devices, the port on one (one battery of four)."""
    shards = []
    real = TC.battery_curves

    def counted(apply_fn, blur_fn, x, *a, **k):
        shards.append(x.shape[0])
        return real(apply_fn, blur_fn, x, *a, **k)

    monkeypatch.setattr(TC, "battery_curves", counted)
    params = save_params(jax_build_bundle("TINY_R", seed=9).params,
                         str(tmp_path / "tiny_r.npz"))
    flags = ["--model", "TINY_R", "--params_path", params, "--attr_func",
             "ig", "--image_batch", "4", "--synthetic", "4",
             "--image_count", "4000"]
    runs = {}
    for name in ("jax", "mesh", "one"):
        out = tmp_path / name
        argv = flags + ["--output_dir", str(out)]
        if name == "jax":
            JD.evaluate_perturbation(JD.build_parser().parse_args(argv))
        else:
            with monkeypatch.context() as m:
                if name == "mesh":
                    m.setattr(TD, "battery_mesh",
                              lambda device, batch: cpu_mesh(4))
                TD.evaluate_perturbation(TD.build_parser().parse_args(argv),
                                         device="cpu")
        runs[name] = _csv(out / "TINY_R" / "ig_4000_images.csv")
    assert shards == [1, 1, 1, 1, 4]
    assert len(runs["mesh"]) == 10
    for k, ref in runs["jax"].items():
        assert abs(runs["mesh"][k] - ref) < 2e-3, (k, runs["mesh"][k], ref)
        assert abs(runs["mesh"][k] - runs["one"][k]) < 1e-6, k
