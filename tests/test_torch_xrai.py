"""XRAI and the port's native Felzenszwalb segmenter against xai_tpu, on
the CPU.

The port compiles its own copy of ``superpixels.cpp`` (``native/``); its
labels must equal those of xai_tpu's library.  XRAI's greedy growth is the
same host numpy: with injected segments it must give xai_tpu's map, and
without them the same segment masks.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_tpu import native as jax_native
from xai_tpu.methods import xrai as JX
from xai_tpu.registry import AttrContext as JaxContext
from xai_tpu.registry import get_attribution as jax_get_attribution
from xai_tpu.runners.common import build_bundle as jax_build_bundle
from xai_tpu.runners.common import save_params

from xai_tpu_torch import native
from xai_tpu_torch.methods import xrai as TX
from xai_tpu_torch.registry import AttrContext, get_attribution
from xai_tpu_torch.runners.common import build_bundle

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


def _image(hw=96, seed=0):
    """4x4 blocks of random colours plus noise, in [-1, 1]: several
    segments at every scale."""
    rs = np.random.RandomState(seed)
    blocks = np.kron(rs.rand(4, 4, 3), np.ones((hw // 4, hw // 4, 1)))
    img = blocks + 0.1 * rs.rand(hw, hw, 3)
    return (2 * img / img.max() - 1).astype(np.float32)


def test_native_copy_is_xai_tpus_source():
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "..", "xai_tpu", "native",
                           "superpixels.cpp"), "rb") as f:
        assert native.SOURCE.read_bytes() == f.read()


@pytest.mark.parametrize("scale,sigma,min_size", [(50, 0.8, 150),
                                                  (100, 0.8, 150),
                                                  (100, 0.5, 20)])
def test_felzenszwalb_labels_match_xai_tpu(scale, sigma, min_size):
    if not jax_native.have_native():
        pytest.skip("xai_tpu's native library did not build here")
    img = _image()
    ref = jax_native.felzenszwalb(img, scale, sigma, min_size)
    got = native.felzenszwalb(img, scale, sigma, min_size)
    assert got.dtype == np.int32 and got.shape == (96, 96)
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(got)) > 1


def test_felzenszwalb_takes_a_single_channel():
    img = _image()[..., 0]
    got = native.felzenszwalb(img, 100.0)
    assert got.shape == (96, 96)
    np.testing.assert_array_equal(
        got, native.felzenszwalb(img[..., None], 100.0))


def test_segments_match_xai_tpu():
    """Six scales, each segment dilated by disk(5), in the same order."""
    img = _image(seed=1)
    ref = JX.get_segments(img)
    got = TX.get_segments(img)
    assert len(got) == len(ref) > 6
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("fast", [False, True], ids=["full", "fast"])
def test_xrai_with_injected_segments_matches_xai_tpu(fast):
    img = _image(seed=2)
    segs = JX.get_segments(img)
    attr = np.random.RandomState(3).randn(96, 96, 3).astype(np.float32)
    if fast:
        ref = JX.xrai_fast(attr.max(-1), segs)
        got = TX.xrai_fast(attr.max(-1), segs)
    else:
        ref = JX.xrai(img, attr, segs=segs)
        got = TX.xrai(img, attr, segs=segs)
    assert got.shape == ref.shape == (96, 96)
    assert np.max(np.abs(got - ref)) <= 1e-5 * np.max(np.abs(ref))


def test_xrai_entry_matches_xai_tpu(tmp_path):
    """The registry entry on TINY_R at 32 px: IG-8 as the base
    attribution, segments of the normalized input."""
    jb = jax_build_bundle("TINY_R", seed=5)
    path = save_params(jb.params, str(tmp_path / "tiny_r.npz"))
    tb = build_bundle("TINY_R", path, device="cpu")
    x = np.random.RandomState(4).randn(32, 32, 3).astype(np.float32)
    target = int(np.argmax(np.asarray(jb.apply(jb.params,
                                               jnp.asarray(x)[None]))[0]))
    ref = jax_get_attribution("cnn", "xrai", JaxContext(
        bundle=jb, x=jnp.asarray(x), trans_img=x, target=target, key=None,
        img_hw=32, steps=8))
    got = get_attribution("cnn", "xrai", AttrContext(
        bundle=tb, x=torch.from_numpy(x), trans_img=x, target=target,
        img_hw=32, steps=8))
    assert got.shape == ref.shape == (32, 32)
    assert np.max(np.abs(got - ref)) <= 1e-5 * np.max(np.abs(ref))
