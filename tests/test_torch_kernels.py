"""xai_tpu_torch kernel modules against xai_tpu on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version; these tests
hold that version against every JAX form of the same function (the dense
conv, the XLA separable form, and the Pallas kernel in interpret mode).
The CUDA kernels themselves are held against the plain versions on the
card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_tpu.kernels.blur_pallas import _factors as jax_factors
from xai_tpu.kernels.blur_pallas import pallas_blur, separable_blur
from xai_tpu.kernels.reveal import pallas_reveal_batch, reveal_batch
from xai_tpu.metrics.curves import pixel_flip_steps as jax_flip_steps
from xai_tpu.ops.blur import gaussian_blur as jax_gaussian_blur

from xai_tpu_torch.kernels import blur as tblur
from xai_tpu_torch.kernels import reveal as treveal
from xai_tpu_torch.ops.blur import make_blur_fn

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

JAX_BLURS = {
    "dense": lambda x, k, s: jax_gaussian_blur(x, k, s),
    "separable": lambda x, k, s: separable_blur(x, k, s),
    "pallas_interpret": lambda x, k, s: pallas_blur(x, k, s, interpret=True),
}


@pytest.fixture(autouse=True)
def _zero_counters():
    tblur.blur_planes.launches = 0
    treveal.reveal_batch.launches = 0
    yield
    # a CPU call takes the plain version and never counts a launch
    assert tblur.blur_planes.launches == 0
    assert treveal.reveal_batch.launches == 0


# the contract of tests/test_kernels.py: |delta| < 1e-5 against the dense
# blur; the forms differ only in float32 summation order (and the rank-1
# factorisation, exact to ~1e-10)
@pytest.mark.parametrize("form", sorted(JAX_BLURS))
@pytest.mark.parametrize("hw,klen,nsig", [(32, 11, 5.0), (64, 31, 31.0)])
def test_blur_plain_matches_jax(form, hw, klen, nsig):
    rs = np.random.RandomState(hw + klen)
    x = rs.rand(2, hw, hw, 3).astype(np.float32)
    ref = np.asarray(JAX_BLURS[form](jnp.asarray(x), klen, nsig))
    planes = torch.from_numpy(x.transpose(0, 3, 1, 2).reshape(6, hw, hw)
                              .copy())
    got = tblur.blur_planes(planes, klen, nsig).numpy()
    got = got.reshape(2, 3, hw, hw).transpose(0, 2, 3, 1)
    assert np.max(np.abs(got - ref)) < 1e-5


def test_make_blur_fn_nchw_matches_separable():
    rs = np.random.RandomState(5)
    x = rs.rand(1, 48, 40, 3).astype(np.float32)       # ragged, non-square
    ref = np.asarray(separable_blur(jnp.asarray(x), 31, 31.0))
    got = make_blur_fn(31, 31.0)(torch.from_numpy(
        x.transpose(0, 3, 1, 2).copy())).numpy().transpose(0, 2, 3, 1)
    assert np.max(np.abs(got - ref)) < 1e-5


def test_blur_factors_are_xai_tpus():
    # the port keeps its own copy of _factors; the kernel's taps must be
    # bit-identical to the TPU kernel's
    for klen, nsig in [(31, 31.0), (11, 5.0)]:
        for mine, theirs in zip(tblur._factors(klen, nsig),
                                jax_factors(klen, nsig)):
            assert np.array_equal(mine, theirs)


@pytest.mark.parametrize("steps", [[0, 4, 8, 12, 16], [7]],
                         ids=["chunk", "ragged_S1"])
@pytest.mark.parametrize("form", ["jnp", "pallas_interpret"])
def test_reveal_plain_matches_jax(form, steps):
    rs = np.random.RandomState(2)
    start = rs.rand(16, 16, 3).astype(np.float32)
    finish = rs.rand(16, 16, 3).astype(np.float32)
    flip = jax_flip_steps(rs.rand(16, 16), 16).reshape(16, 16)
    st = np.asarray(steps, np.int32)
    if form == "jnp":
        ref = reveal_batch(jnp.asarray(start), jnp.asarray(finish),
                           jnp.asarray(flip), jnp.asarray(st))
    else:
        ref = pallas_reveal_batch(jnp.asarray(start), jnp.asarray(finish),
                                  flip, st, interpret=True)
    ref = np.asarray(ref).transpose(0, 3, 1, 2)          # -> NCHW
    got = treveal.reveal_chunk(
        torch.from_numpy(start.transpose(2, 0, 1).copy()),
        torch.from_numpy(finish.transpose(2, 0, 1).copy()),
        torch.from_numpy(flip), torch.from_numpy(st)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.array_equal(got, ref)                      # a select: exact


@pytest.mark.parametrize("b,s,h,w", [(3, 7, 15, 13), (2, 45, 16, 16)],
                         ids=["ragged", "chunk45"])
@pytest.mark.parametrize("form", ["jnp", "pallas_interpret"])
def test_reveal_batch_plain_matches_jax_per_image(form, b, s, h, w):
    """[B, S, C, H, W] in one call, image by image equal to xai_tpu's
    per-image reveal_batch / pallas_reveal_batch(interpret=True)."""
    rs = np.random.RandomState(b + s)
    start = rs.rand(b, h, w, 3).astype(np.float32)
    finish = rs.rand(b, h, w, 3).astype(np.float32)
    flip = np.stack([jax_flip_steps(rs.rand(h, w), h).reshape(h, w)
                     for _ in range(b)])
    st = np.arange(2, 2 + s, dtype=np.int32)
    got = treveal.reveal_batch(
        torch.from_numpy(start.transpose(0, 3, 1, 2).copy()),
        torch.from_numpy(finish.transpose(0, 3, 1, 2).copy()),
        torch.from_numpy(flip), torch.from_numpy(st)).numpy()
    assert got.dtype == np.float32 and got.shape == (b, s, 3, h, w)
    for i in range(b):
        if form == "jnp":
            ref = reveal_batch(jnp.asarray(start[i]), jnp.asarray(finish[i]),
                               jnp.asarray(flip[i]), jnp.asarray(st))
        else:
            ref = pallas_reveal_batch(jnp.asarray(start[i]),
                                      jnp.asarray(finish[i]), flip[i], st,
                                      interpret=True)
        assert np.array_equal(got[i], np.asarray(ref).transpose(0, 3, 1, 2))


def test_reveal_chunk_is_the_one_image_batch():
    rs = np.random.RandomState(4)
    start, finish = (torch.from_numpy(rs.rand(3, 9, 11).astype(np.float32))
                     for _ in range(2))
    flip = torch.from_numpy(jax_flip_steps(rs.rand(9, 11), 9).reshape(9, 11))
    st = torch.tensor([0, 3, 11], dtype=torch.int32)
    one = treveal.reveal_chunk(start, finish, flip, st)
    assert torch.equal(one, treveal.reveal_batch(
        start[None], finish[None], flip[None], st)[0])
    assert one.shape == (3, 3, 9, 11)


@pytest.mark.parametrize("klen,nsig", [(31, 31.0), (11, 5.0), (63, 20.0)])
def test_blur_host_taps_are_what_the_kernel_reads(klen, nsig):
    # the kernel copies klen float32 taps a pass from host memory
    for taps in tblur._factors(klen, nsig):
        assert taps.dtype == np.float32 and taps.shape == (klen,)
        assert taps.flags["C_CONTIGUOUS"] and (taps > 0).all()


@pytest.mark.parametrize("name", ["blur", "reveal", "quickshift", "bn_act",
                                  "layernorm"])
def test_build_names_one_library_per_source(name):
    # a library's name hashes its source and the nvcc flags: an edited
    # source is rebuilt, never loaded stale; nothing is built to name it
    from xai_tpu_torch.kernels import _build
    assert name in _build.KERNELS
    assert (_build.CSRC / f"{name}.cu").is_file()
    path = _build.lib_path(name)
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert path.name.startswith(f"lib{name}-")
    assert path == _build.lib_path(name)
    others = {_build.lib_path(n) for n in _build.KERNELS if n != name}
    assert path not in others
