"""TIS, ViT-CX, MDA and MDA_dense of xai_tpu_torch against xai_tpu's, on
the CPU.

The model is xai_tpu's 32 px test ViT at its init of PRNGKey(0) (2
blocks of 32 wide, a 4 x 4 patch grid, 16 classes), carried through
``.npz``.  The randomness of the two packages cannot match (JAX PRNG
against torch generators), so it is injected into both: TIS's
centroids (and k-means' initial points), ViT-CX's noise.  MDA has no
randomness: with the same superpixels (the native SLIC, the same source
in both packages) its picks must be equal, and its maps within 1e-4.
Where a pick could flip, ``assert_picks`` does what chip_smoke's AGI
check does: it finds the first flipped round, requires the flip to be a
rounding-level tie, and holds the run up to that round.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_tpu.methods import mda as JM
from xai_tpu.methods import tis as JT
from xai_tpu.methods import vit_cx as JX
from xai_tpu.ops.blur import make_blur_fn as jax_blur
from xai_tpu.registry import AttrContext as JCtx
from xai_tpu.registry import get_attribution as jax_get_attribution

from xai_tpu_torch.methods import batch as TB
from xai_tpu_torch.methods import mda as TM
from xai_tpu_torch.methods import tis as TT
from xai_tpu_torch.methods import vit_cx as TX
from xai_tpu_torch.models import vit as tvit
from xai_tpu_torch.ops.blur import make_blur_fn
from xai_tpu_torch.registry import AttrContext, adaptive_blur, \
    get_attribution

from test_torch_vit import close, tiny_vit_twins
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

TARGETS = [3, 0, 11]
N_MASKS = 64
# a flipped greedy pick is a rounding-level tie: its two candidates'
# softmax responses within this of each other
PICK_TIE = 1e-5


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    jb, tb = tiny_vit_twins(str(tmp_path_factory.mktemp("p") / "vit.npz"))
    xs = np.random.RandomState(2).randn(3, 32, 32, 3).astype(np.float32)
    trans = np.random.RandomState(3).rand(3, 32, 32, 3).astype(np.float32)
    return jb, tb, xs, trans


# --- the model's per-row token dropping ---

def test_per_row_token_indices_equal_single_runs(twins):
    _, tb, xs, _ = twins
    x = torch.from_numpy(xs.transpose(0, 3, 1, 2).copy())
    idx = torch.stack([torch.randperm(16, generator=torch.Generator()
                                      .manual_seed(i))[:8] for i in range(3)])
    with torch.no_grad():
        rows = tb.apply_tokens(x, idx)
        for i in range(3):
            close(rows[i], tb.apply_tokens(x[i:i + 1], idx[i])[0], 1e-6)


# --- TIS ---

def test_kmeans_matches_with_a_shared_init(twins):
    jb, _, xs, _ = twins
    _, taps = jb.apply_taps(jb.params, jnp.asarray(xs[:1]))
    blocks = taps["block_out"]
    acts = jnp.concatenate([blocks[i, 0] for i in range(blocks.shape[0])],
                           -1)[1:].T
    key = jax.random.PRNGKey(4)
    # xai_tpu's own initial draw, handed to the port
    init = np.asarray(jax.random.choice(key, acts.shape[0], (16,),
                                        replace=False))
    ref = JT.kmeans(acts, key, 16)
    got = TT.kmeans(torch.from_numpy(np.array(acts)), None, 16,
                    init=torch.from_numpy(init))
    close(got, ref, 1e-5)


@pytest.mark.parametrize("i", range(3))
def test_tis_matches_with_shared_centroids(twins, i):
    jb, tb, xs, _ = twins
    cent = np.random.RandomState(i).rand(N_MASKS, 16).astype(np.float32)
    ref = JT.tis(jb, xs[i], TARGETS[i], n_masks=N_MASKS, centroids=cent)
    got = TT.tis(tb, torch.from_numpy(xs[i]), TARGETS[i], n_masks=N_MASKS,
                 centroids=cent)
    close(got, ref, 1e-4)


def test_tis_runs_kmeans_from_the_generator(twins):
    _, tb, xs, _ = twins
    x = torch.from_numpy(xs[0])
    a, b, c = (TT.tis(tb, x, 3, n_masks=N_MASKS,
                      generator=torch.Generator().manual_seed(s))
               for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (4, 4) and float(a.min()) == 0 and float(a.max()) == 1


# --- ViT-CX ---

def _jax_labels(jb, x):
    _, tri, _ = JX._masks_and_sim_jit(jb.apply_taps, jb.params,
                                      jnp.asarray(x)[None], 32)
    return JX._cluster_host(np.asarray(tri), 32, 0.1)


def _noise(k, seed):
    return (np.random.RandomState(seed).randn(k, 32, 32, 3) * 0.1) \
        .astype(np.float32)


@pytest.mark.parametrize("i", range(3))
def test_vit_cx_matches_with_shared_noise(twins, i):
    jb, tb, xs, _ = twins
    labels = _jax_labels(jb, xs[i])
    masks, sim, _ = TX._masks_and_sim(
        tb, torch.from_numpy(xs[i:i + 1].transpose(0, 3, 1, 2).copy()))
    assert np.array_equal(TX.cluster_host(sim[0].numpy(), 0.1), labels)
    noise = _noise(int(labels.max()) + 1, i)
    ref = JX.vit_cx(jb, xs[i], TARGETS[i], noise=noise)
    got = TX.vit_cx(tb, torch.from_numpy(xs[i]), TARGETS[i], noise=noise)
    close(got, ref, 1e-4)


def test_vit_cx_batch_matches_single_runs_and_xai_tpu(twins):
    jb, tb, xs, _ = twins
    noise = [_noise(int(_jax_labels(jb, x).max()) + 1, 10 + i)
             for i, x in enumerate(xs)]
    got = TX.vit_cx_batch(tb, xs, TARGETS, noise=noise)
    for i in range(3):
        single = TX.vit_cx(tb, torch.from_numpy(xs[i]), TARGETS[i],
                           noise=noise[i])
        close(got[i], single, 1e-5)
        close(got[i], JX.vit_cx(jb, xs[i], TARGETS[i], noise=noise[i]), 1e-4)


def test_vit_cx_batch_across_a_bucket_equals_single_runs(twins,
                                                         monkeypatch):
    """Cluster counts on both sides of a bucket: the test ViT's 32 feature
    maps make 17, 17 and 19 clusters, so a bucket of 18 stands in for the
    64 of a 768-wide ViT.  The batch pads to the larger bucket (36), and
    each image's noise, drawn from its own generator at its own bucket,
    is the single run's."""
    _, tb, xs, _ = twins
    monkeypatch.setattr(TX, "BUCKET", 18)
    sims = TX._masks_and_sim(tb, torch.from_numpy(
        xs.transpose(0, 3, 1, 2).copy()))[1]
    ks = [int(TX.cluster_host(s.numpy(), 0.1).max()) + 1 for s in sims]
    assert [TX._bucket(k) for k in ks] == [18, 18, 36], ks
    got = TX.vit_cx_batch(tb, xs, TARGETS, generators=[
        torch.Generator().manual_seed(20 + i) for i in range(3)])
    for i in range(3):
        single = TX.vit_cx(tb, torch.from_numpy(xs[i]), TARGETS[i],
                           generator=torch.Generator().manual_seed(20 + i))
        close(got[i], single, 1e-5)


# --- MDA ---

def _grid_segments():
    seg = np.zeros((32, 32), np.int32)
    for i in range(4):
        for j in range(4):
            seg[i * 8:(i + 1) * 8, j * 8:(j + 1) * 8] = i * 4 + j
    return seg


def _replay(tb, start, finish, seg, chosen, cand, target):
    """The port's float32 response of inserting ``cand`` into the image
    that ``chosen`` leaves."""
    cur = np.asarray(start).copy()
    for s in chosen:
        cur = np.where((seg == s)[..., None], finish, cur)
    img = np.where((seg == cand)[..., None], finish, cur)
    x = torch.from_numpy(img.transpose(2, 0, 1)[None].astype(np.float32))
    return float(tb.probs(x)[0, target])


def assert_picks(tb, got, want, start, finish, seg, target, skip=()):
    """Equal picks, or equal up to a first flipped round whose two picks
    score within PICK_TIE of each other (then the run up to it stands)."""
    got, want = [int(v) for v in got], [int(v) for v in want]
    if got == want:
        return len(got)
    r = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    chosen = list(skip) + got[:r]
    a = _replay(tb, start, finish, seg, chosen, got[r], target)
    b = _replay(tb, start, finish, seg, chosen, want[r], target)
    assert abs(a - b) <= PICK_TIE, (r, got, want, a, b)
    return r


@pytest.mark.parametrize("i", range(3))
def test_insertion_search_picks_match(twins, i):
    jb, tb, xs, _ = twins
    seg = _grid_segments()
    prior = np.abs(np.random.RandomState(i).randn(32, 32, 3)) \
        .astype(np.float32)
    ref = JM.find_insertion_patches(jb, xs[i], prior, seg,
                                    jax_blur(31, 31.0), 16, TARGETS[i])
    got = TM.find_insertion_patches(tb, torch.from_numpy(xs[i]), prior, seg,
                                    make_blur_fn(31, 31.0), 16, TARGETS[i])
    start = np.asarray(jax_blur(31, 31.0)(jnp.asarray(xs[i])[None])[0])
    r = assert_picks(tb, got[0], ref[0], start, xs[i], seg, TARGETS[i])
    np.testing.assert_allclose(got[1][:r], ref[1][:r], atol=1e-5)


@pytest.mark.parametrize("i", range(3))
def test_mda_and_mda_dense_match_with_injected_segments(twins, i):
    jb, tb, xs, trans = twins
    seg = _grid_segments()
    prior = np.abs(np.random.RandomState(i).randn(32, 32, 3)) \
        .astype(np.float32)
    x = torch.from_numpy(xs[i])
    close(TM.mda(tb, trans[i], x, prior, 16, make_blur_fn(31, 31.0),
                 TARGETS[i], segments=seg),
          JM.mda(jb, trans[i], xs[i], prior, 16, jax_blur(31, 31.0),
                 TARGETS[i], segments=seg), 1e-4)
    # xai_tpu's mda_dense takes no segments: both run the same native SLIC
    close(TM.mda_dense(tb, trans[i], x, prior, 16, make_blur_fn(31, 31.0),
                       TARGETS[i]),
          JM.mda_dense(jb, trans[i], xs[i], prior, 16, jax_blur(31, 31.0),
                       TARGETS[i]), 1e-4)


def test_deletion_search_with_a_seeded_tail_matches(twins):
    """The deletion search seeded by 12 insertion picks: a tail window
    shorter than the subsearch, and the tail's cumulative reveals in one
    batched forward."""
    jb, tb, xs, trans = twins
    seg = _grid_segments()
    prior = np.abs(np.random.RandomState(7).randn(32, 32, 3)) \
        .astype(np.float32)
    seed_order = list(np.random.RandomState(8).permutation(16)[:12])
    ref = JM.find_deletion_patches(jb, xs[1], seg, prior, seed_order,
                                   jax_blur(31, 31.0), 16, TARGETS[1])
    got = TM.find_deletion_patches(tb, torch.from_numpy(xs[1]), seg, prior,
                                   seed_order, make_blur_fn(31, 31.0), 16,
                                   TARGETS[1])
    for g, r in zip(got, ref):
        close(g, r, 1e-4)


@pytest.mark.parametrize("name", ["MDA", "MDA_dense"])
def test_mda_registry_entry_matches(twins, name):
    """The registry entry: the adaptive blur (the test ViT's flat softmax
    keeps the target above 1 %, so klen runs to 103, the blur's two-launch
    width), bidirectional's prior, SLIC, the 3x abs for MDA."""
    jb, tb, xs, trans = twins
    x, t = xs[0], TARGETS[0]
    _, klen = adaptive_blur(tb, torch.from_numpy(x), t)
    assert klen == 103
    ref = jax_get_attribution("vit", name, JCtx(
        bundle=jb, x=jnp.asarray(x), trans_img=trans[0], target=t,
        key=jax.random.PRNGKey(0), img_hw=32))
    got = get_attribution("vit", name, AttrContext(
        bundle=tb, x=torch.from_numpy(x), trans_img=trans[0], target=t,
        img_hw=32))
    assert got.shape == (32, 32)
    close(got, ref, 1e-4)


@pytest.mark.parametrize("case", ["ins", "del"])
def test_mda_bf16_keeps_xai_tpus_contract(twins, case):
    """xai_tpu's bf16 MDA contract (tests/test_mda_scan_differential.py
    test_scan_bf16_rank_stable): the main-window picks equal the float32
    picks, and every bf16 pick, replayed in float32 at the bf16 run's own
    state, lies within 0.02 of the float32-best candidate."""
    _, tb, xs, _ = twins
    seg = _grid_segments()
    rs = np.random.RandomState(3)
    x = xs[0]
    start = np.zeros_like(x)
    order = list(rs.permutation(16))
    target, n = 3, 16
    skip = order[:5] if case == "del" else None
    kw = dict(n_searches=n, skip=skip)
    if case == "ins":
        kw.update(direction="max", cutoff=1, norm_pair=(1.0, 0.0))
    else:
        kw.update(direction="min")
    xt, st = torch.from_numpy(x), torch.from_numpy(start)
    f32_p, _, _, _ = TM._greedy_search(tb, st, xt, seg, order, n, target,
                                       **kw)
    bf_p, _, _, _ = TM._greedy_search(tb, st, xt, seg, order, n, target,
                                      dtype=torch.bfloat16, **kw)
    assert len(bf_p) == len(f32_p)
    subsearch = min(int(n ** 0.5) * 2, 28)
    main = max(n - subsearch - (len(skip) if skip else 0), 0)
    assert bf_p[:main] == f32_p[:main]
    chosen = list(skip or [])
    for r, k in enumerate(TM._schedule(n, n, skip)[:len(bf_p)]):
        cands = [s for s in order if s not in chosen][:k]
        scores = {c: _replay(tb, start, x, seg, chosen, c, target)
                  for c in cands}
        best = (max if kw["direction"] == "max" else min)(scores.values())
        assert bf_p[r] in cands and abs(scores[bf_p[r]] - best) <= 0.02
        chosen.append(bf_p[r])


# --- the batched entry and the bf16 question ---

def test_only_vit_cx_batches(twins):
    _, tb, xs, trans = twins
    assert TB.has_batch_impl("vit", "VIT_CX")
    for name in ("TIS", "MDA", "MDA_dense"):
        assert not TB.has_batch_impl("vit", name)
        assert TB.batch_attribution("vit", name, tb, xs[:2], trans[:2],
                                    [1, 2], None, img_hw=32) is None


@pytest.mark.parametrize("name", ["TIS", "VIT_CX", "MDA"])
def test_bf16_scoring_forwards_run_bf16(twins, name, monkeypatch):
    """The three names take the context's dtype for their scoring
    forwards.  Recorded on the CPU: xai_tpu's bf16 TIS, ViT-CX and MDA
    forwards do run in bf16, inputs and parameters (unlike its gradient
    explainers, no float32 probe promotes them), and so do the port's."""
    jb, tb, xs, trans = twins
    seen = []

    def spy(fn):
        def wrapped(p, x, *a):
            seen.append((x.dtype, jax.tree.leaves(p)[0].dtype))
            return fn(p, x, *a)
        return wrapped

    jb = dataclasses.replace(jb, apply=spy(jb.apply),
                             apply_tokens=spy(jb.apply_tokens))
    x, noise = xs[0], _noise(int(_jax_labels(jb, xs[0]).max()) + 1, 0)
    prior = np.ones((32, 32, 3), np.float32)
    if name == "TIS":
        JT.tis(jb, x, 3, n_masks=N_MASKS, dtype=jnp.bfloat16)
    elif name == "VIT_CX":
        JX.vit_cx(jb, x, 3, noise=noise, dtype=jnp.bfloat16)
    else:
        JM.mda(jb, trans[0], x, prior, 16, jax_blur(31, 31.0), 3,
               dtype=jnp.bfloat16, segments=_grid_segments())
    bf16 = np.dtype(jnp.bfloat16)
    assert (bf16, bf16) in set(seen)

    seen.clear()
    forward = tvit.VisionTransformer.forward

    def record(self, xb, *a, **k):
        seen.append((xb.dtype, self.head.weight.dtype))
        return forward(self, xb, *a, **k)

    monkeypatch.setattr(tvit.VisionTransformer, "forward", record)
    xt = torch.from_numpy(x)
    if name == "TIS":
        got = TT.tis(tb, xt, 3, n_masks=N_MASKS, dtype=torch.bfloat16)
    elif name == "VIT_CX":
        got = TX.vit_cx(tb, xt, 3, noise=noise, dtype=torch.bfloat16)
    else:
        got = TM.mda(tb, trans[0], xt, prior, 16, make_blur_fn(31, 31.0), 3,
                     dtype=torch.bfloat16, segments=_grid_segments())
    assert (torch.bfloat16, torch.bfloat16) in set(seen)
    assert np.isfinite(np.asarray(got, np.float32)).all()


def test_tis_needs_as_many_points_as_masks(twins):
    """xai_tpu's k-means draws its initial centroids without replacement,
    so TIS's 1024 masks need 1024 activation rows (depth x width); the
    32 px test ViT has 64, and both packages refuse it."""
    jb, tb, xs, _ = twins
    with pytest.raises(ValueError):
        JT.tis(jb, xs[0], 3)
    with pytest.raises(ValueError, match="without replacement"):
        TT.tis(tb, torch.from_numpy(xs[0]), 3)
