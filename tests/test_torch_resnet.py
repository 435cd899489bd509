"""The ResNet port and the weight carry against xai_tpu on the CPU.

xai_tpu's TINY_R params (with randomized folded-BN scale/bias, so the
carry of every array matters) are written with xai_tpu's own save_params
and read by the port's build_bundle(--params_path); logits, taps and the
input gradient must match the JAX bundle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_tpu.models import resnet as jres
from xai_tpu.runners.common import build_bundle as jax_build_bundle
from xai_tpu.runners.common import save_params

from xai_tpu_torch.convert.from_jax import load_params
from xai_tpu_torch.models import resnet as tres
from xai_tpu_torch.runners.common import build_bundle

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

HW = 64


def _close(got, ref, rel):
    """Max |delta| within ``rel`` of the reference's magnitude: the two
    packages' float32 convolutions (XLA CPU vs oneDNN) sum in different
    orders, which moves results by ~1e-6 relative per layer."""
    scale = float(np.max(np.abs(ref)))
    assert scale > 0
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(ref))))
    assert err <= rel * scale, (err, scale)


def _randomize_bn(params, rs):
    def visit(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                visit(v)
            elif k in ("scale", "bias") and v.ndim == 1:
                base = 1.0 if k == "scale" else 0.0
                tree[k] = jnp.asarray(
                    base + 0.2 * rs.randn(*v.shape).astype(np.float32))
    params = jax.tree.map(lambda a: a, params)
    visit(params)
    return params


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    jb = jax_build_bundle("TINY_R", seed=3)
    params = _randomize_bn(jb.params, np.random.RandomState(0))
    path = str(tmp_path_factory.mktemp("params") / "tiny_r.npz")
    save_params(params, path)
    tb = build_bundle("TINY_R", path, device="cpu")
    x = np.random.RandomState(1).randn(2, HW, HW, 3).astype(np.float32)
    return jb, params, tb, x


def test_logits_match(twins):
    jb, params, tb, x = twins
    ref = np.asarray(jb.apply(params, jnp.asarray(x)))
    got = tb.apply(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("tap", ["layer1", "layer4", "pool"])
def test_taps_match(twins, tap):
    jb, params, tb, x = twins
    _, jt = jb.apply_taps(params, jnp.asarray(x))
    _, tt = tb.apply_taps(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    got = tt[tap].numpy()
    if got.ndim == 4:
        got = got.transpose(0, 2, 3, 1)                  # NCHW -> NHWC
    _close(got, np.asarray(jt[tap]), 1e-5)


def test_input_gradient_matches(twins):
    jb, params, tb, x = twins
    target = 7
    jg, js = jb.score_and_grad_fn(params, jnp.asarray(x), target)
    tg, ts = tb.score_and_grad(
        torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), target)
    _close(ts, np.asarray(js), 1e-5)
    _close(tg.numpy().transpose(0, 2, 3, 1), np.asarray(jg), 1e-5)
    # gradients are taken with respect to the input only
    assert all(p.grad is None for p in tb.module.parameters())


def test_layer4_probe_gradient_matches(twins):
    """A zero probe added to a stage output: its gradient is the gradient
    with respect to that activation (Grad-CAM's layer4 hook)."""
    jb, params, tb, x = twins
    target = 3
    _, jt = jb.apply_taps(params, jnp.asarray(x))
    jprobe = jnp.zeros_like(jt["layer4"])

    def jscore(pr):
        return jb.apply_probed(params, jnp.asarray(x),
                               {"layer4": pr})[0][:, target].sum()

    ref = np.asarray(jax.grad(jscore)(jprobe))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    probe = torch.zeros(ref.shape[0], ref.shape[3], ref.shape[1],
                        ref.shape[2], requires_grad=True)
    logits, taps = tb.module(xt, taps=True, probes={"layer4": probe})
    (got,) = torch.autograd.grad(logits[:, target].sum(), probe)
    _close(got.numpy().transpose(0, 2, 3, 1), ref, 1e-5)
    _close(taps["layer4"].detach().numpy().transpose(0, 2, 3, 1),
           np.asarray(jt["layer4"]), 1e-5)


def test_grouped_block_carry(tmp_path):
    """The RNXT layout: a grouped 3x3 conv's HWIO kernel [3, 3, in/g, out]
    carries to OIHW [out, in/g, 3, 3]."""
    block = jres.Bottleneck(width=16, out_features=32, stride=2, groups=4)
    x = np.random.RandomState(4).randn(2, 12, 12, 8).astype(np.float32)
    params = block.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = _randomize_bn(params, np.random.RandomState(5))
    ref = np.asarray(block.apply({"params": params}, jnp.asarray(x)))
    path = str(tmp_path / "block.npz")
    save_params(params, path)
    tb = tres.Bottleneck(8, 16, 32, stride=2, groups=4)
    tb.load_state_dict(load_params(path))
    assert tb.conv2.weight.shape == (16, 4, 3, 3)
    got = tb(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    _close(got.detach().numpy().transpose(0, 2, 3, 1), ref, 1e-5)


def test_load_params_reads_only_npz(tmp_path):
    with pytest.raises(ValueError, match="npz"):
        load_params(str(tmp_path / "p.msgpack"))
