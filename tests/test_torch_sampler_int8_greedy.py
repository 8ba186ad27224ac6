"""Greedy ``sample_video`` of the port's quantized sampler against lvt_tpu's
in the same mode, on the tiny geometries and modes of
tests/test_torch_sampler_int8.py: the codes agree with lvt_tpu's at >= 98%
and with the port's native codes at lvt_tpu's own bar for the mode
(tests/test_vt_incremental.py): >= 90%, and >= 75% with the int4 cache,
whose rounding is 16x coarser."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sampler_int8 import GEOMETRIES, MODE_IDS, MODES, _knobs
from test_torch_vt import CASES, _models

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_greedy_codes_track_jax_and_native(rng, geometry, mode):
    case = CASES[GEOMETRIES[geometry]]
    jm, jp, tm, tp = _models(case)
    video = rng.integers(0, jm.c.nv, size=(2, jm.c.nc, *case[3])).astype(np.int32)
    knobs, kv = _knobs(mode)
    want = np.asarray(jm.sample_video(jp, jnp.asarray(video), jax.random.key(5), n_prime=1,
                                      greedy=True, kv_cache_dtype=kv, **knobs))
    tv = torch.from_numpy(video)
    got = tm.sample_video(tp, tv, n_prime=1, greedy=True, kv_cache_dtype=kv, **knobs).numpy()
    native = tm.sample_video(tp, tv, n_prime=1, greedy=True).numpy()
    assert got.shape == want.shape and got.min() >= 0 and got.max() < tm.c.nv
    assert np.array_equal(got[:, :, :1], video[:, :, :1])  # the primed frame is kept
    assert float((got == want).mean()) >= 0.98, float((got == want).mean())
    floor = 0.75 if kv == "int4" else 0.90
    assert float((got == native).mean()) >= floor, float((got == native).mean())
