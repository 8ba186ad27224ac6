"""The port's Video Transformer held to lvt_tpu on the tiny geometries of
tests/test_vt_incremental.py, weights carried across with from_jax_vt:

* teacher-forced vt_logits within 1e-4 (fp32);
* the port's KV-cached greedy rollout equals its full-recompute rollout;
* the incremental decoder's teacher logits match vt_logits;
* greedy sample_video codes equal lvt_tpu's. Where they differ, the first
  differing code in sampling order must sit at a true near-tie: lvt_tpu's
  own top-2 logit margin there below 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu.config import get_cfg
from lvt_tpu.models.vt import VideoTransformer as JaxVT
from lvt_tpu.models.vt import vt_logits as jax_vt_logits
from lvt_tpu_torch.checkpoint import from_jax_vt
from lvt_tpu_torch.models.vt import VideoTransformer, vt_encode, vt_logits
from lvt_tpu_torch.models.vt_incremental import sample_slice_incremental

NEAR_TIE = 1e-5
# one compile per geometry instead of an eager op-by-op run
_jax_logits = jax.jit(jax_vt_logits, static_argnums=(1,), static_argnames=("use_pallas",))

CASES = [  # (stride, kernel, blocks, (T, H, W)), as tests/test_vt_incremental.py
    ((4, 1, 1), (3, 1, 1), ((1, 4, 4),) * 2, (4, 4, 4)),
    ((1, 2, 2), (1, 3, 3), ((2, 2, 2),) * 2, (4, 4, 4)),
    ((2, 2, 2), (3, 3, 3), ((2, 2, 2),) * 2, (4, 4, 4)),
    ((4, 1, 1), (3, 1, 1), ((1, 2, 2),) * 2, (4, 4, 4)),
    ((1, 2, 1), (1, 3, 3), ((2, 2, 2),) * 2, (2, 4, 6)),
    ((2, 1, 2), (3, 1, 3), ((1, 4, 2),) * 2, (4, 4, 4)),
]
IDS = ["dsfvt", "dssvt", "dstsvt", "subblock", "nonsquare", "tallgrid"]


def _cfg(stride, kernel, blocks, nc=2, nv=8):
    cfg = get_cfg()
    cfg.MODEL.META_ARCHITECTURE = "VideoTransformerModel"
    cfg.MODEL.AUTOREGRESSIVE.NAME = "VideoTransformer"
    v = cfg.MODEL.AUTOREGRESSIVE.VT
    v.NC, v.NV = nc, nv
    v.KERNEL, v.STRIDE = kernel, stride
    v.D, v.DA, v.DE = 32, 16, 16
    v.BLOCKS_E = v.BLOCKS_D = blocks
    v.N_HEAD_E = v.N_HEAD_D = (2,) * len(blocks)
    v.N_PRIME = 1
    v.SHARE_P = False
    return cfg


def _models(case, seed=0):
    stride, kernel, blocks, THW = case
    cfg = _cfg(stride, kernel, blocks)
    jm = JaxVT(cfg, T=THW[0], H=THW[1], W=THW[2])
    jp, _ = jm.init(jax.random.key(seed))
    tp = {"netG": from_jax_vt(jax.tree_util.tree_map(np.array, jp["netG"]))}
    return jm, jp, VideoTransformer(cfg, T=THW[0], H=THW[1], W=THW[2]), tp


def _slice_inputs(m, video, s):
    """(ctx, slice codes, slice index) of slice s, on the port's side."""
    sidx = torch.full((video.shape[0],), s, dtype=torch.int64)
    ctx, sl, _ = m.prepare_slices(torch.from_numpy(video), sidx)
    return ctx, sl, sidx


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_vt_logits_match(rng, case):
    jm, jp, tm, tp = _models(case)
    THW = case[3]
    video = rng.integers(0, jm.c.nv, size=(2, jm.c.nc, *THW)).astype(np.int64)
    for s in (0, jm.plan.num_slices - 1):
        ctx, sl, sidx = _slice_inputs(tm, video, s)
        want = np.asarray(_jax_logits(jp["netG"], jm.c, jnp.asarray(ctx.numpy()),
                                        jnp.asarray(sl.numpy()), jnp.asarray(sidx.numpy()),
                                        use_pallas=False))
        got = vt_logits(tp["netG"], tm.c, ctx, sl, sidx).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_incremental_equals_full_recompute_greedy(rng, case):
    _, _, tm, tp = _models(case)
    video = torch.from_numpy(rng.integers(0, tm.c.nv, size=(2, tm.c.nc, *case[3])))
    inc = tm.sample_video(tp, video, n_prime=1, greedy=True)
    full = tm.sample_video(tp, video, n_prime=1, greedy=True, incremental=False)
    assert torch.equal(inc, full)
    assert not torch.equal(inc, video)  # something was sampled


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_teacher_logits_match_vt_logits(rng, case):
    _, _, tm, tp = _models(case)
    video = rng.integers(0, tm.c.nv, size=(2, tm.c.nc, *case[3])).astype(np.int64)
    s = tm.plan.num_slices // 2
    ctx, sl, sidx = _slice_inputs(tm, video, s)
    want = vt_logits(tp["netG"], tm.c, ctx, sl, sidx).reshape(2, -1, tm.c.nc, tm.c.nv)
    zl = vt_encode(tp["netG"], tm.c, ctx, sidx)
    out, got = sample_slice_incremental(tp["netG"], tm.c, tm.plan.slice_shape, zl, sl, None,
                                        np.ones(sl[0, 0].numel(), bool), 1.0,
                                        teacher_logits=True)
    assert torch.equal(out, sl)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def first_difference(plan, got, want, n_prime, H, W):
    """(b, flat video index, channel) of the first differing code in the
    sampler's order (slice, raster position, channel), or None."""
    b, nc = want.shape[:2]
    g, w = got.reshape(b, nc, -1), want.reshape(b, nc, -1)
    for s in range(plan.num_slices):
        for idx in plan.slice_src[s].reshape(-1):
            if idx // (H * W) < n_prime:
                continue
            for k in range(nc):
                rows = np.nonzero(g[:, k, idx] != w[:, k, idx])[0]
                if len(rows):
                    return int(rows[0]), int(idx), k
    return None


def assert_greedy_codes_match(jm, jp, got, want, n_prime):
    """Equal codes, or a first difference at a true near-tie of lvt_tpu's
    own teacher-forced logits."""
    T, H, W = want.shape[2:]
    diff = first_difference(jm.plan, got, want, n_prime, H, W)
    if diff is None:
        return
    b, idx, k = diff
    lg = np.asarray(jm.logits_for_entire_video(jp, jnp.asarray(want)))
    row = np.sort(lg.reshape(lg.shape[0], -1, *lg.shape[-2:])[b, idx, k])
    assert row[-1] - row[-2] < NEAR_TIE, (diff, row[-1] - row[-2])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_greedy_sample_video_matches_jax(rng, case):
    jm, jp, tm, tp = _models(case)
    video = rng.integers(0, jm.c.nv, size=(2, jm.c.nc, *case[3])).astype(np.int32)
    want = np.asarray(jm.sample_video(jp, jnp.asarray(video), jax.random.key(11), n_prime=1,
                                      greedy=True))
    got = tm.sample_video(tp, torch.from_numpy(video), n_prime=1, greedy=True).numpy()
    assert_greedy_codes_match(jm, jp, got, want, 1)
