"""The port's sampler in every mode under tensor parallelism, held to
lvt_tpu on the CPU. One world of 4 gloo processes, data 2 x model 2
(TPU.MESH_MODEL 2), spawned once for the module through engine.launch
(tests/torch_tp_worker.py ``tp_sampler_scenarios``), samples
tests/test_multichip_sampling.py's tiny VT (2 heads, d 32; one head a rank)
on its data index's 4 of 8 rows; lvt_tpu runs beside it in this process,
its Pallas kernels in interpret mode (its default off the TPU).

* Greedy ``sample_video`` in each mode of MODES: the two ranks of each model
  group give the same codes; natively and with ``streams`` the codes equal
  lvt_tpu's rollout of the 8 rows bit for bit, and in the quantized modes
  they agree with lvt_tpu's in the same mode at the quantized sampler's
  rule, >= 98 % (tests/test_torch_sampler_int8_greedy.py). lvt_tpu's own
  tensor-parallel rollout ((4, 2) mesh) equals its replicated one in the
  int8 + pallas mode.
* Teacher-forced logits (``logits_for_entire_video_incremental``) with the
  int8 and int4 caches, and of one slice (``sample_slice_incremental``)
  with int8 weights natively and through kernel 11's plain version (the
  group's column and row scales), within tests/test_torch_sampler_int8.py's
  bound of lvt_tpu's in the same mode, by that file's near-tie rule.
* A rank's int8 weights: proj and FFN 2 (split by their rows) are its rows
  of the whole weight's quantization, with the whole weight's column
  scales; FFN 1 (split by its columns) its columns. Kernel 11's plain
  version over a row-split product (``matmul_i8w_split``) is the whole
  product bit for bit; in bf16 the native and int8 row-split products are
  the whole product rounded once, after the group's fp32 sum.
* Two machines of 2 processes each (engine.launch with num_machines=2 and a
  tcp:// address): each model group lies on one machine's consecutive
  ranks, and the rollout equals the world of one's.
"""

import datetime
import os
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from lvt_tpu.config import get_cfg as jax_get_cfg
from lvt_tpu.models import vt_incremental as jvti
from lvt_tpu.models.vt import VideoTransformer as JaxVT
from lvt_tpu.models.vt import vt_encode as jax_vt_encode
from lvt_tpu.parallel.mesh import build_mesh
from lvt_tpu.parallel.sharding import shard_tree as jax_shard_tree
from lvt_tpu_torch.models.vt import VideoTransformer
from lvt_tpu_torch.ops.quant import quantize_cols
from test_torch_data_parallel import _jax_tree_of_port_init
from test_torch_sampler_int8 import LOGIT_TOL, TIE_MARGIN
from test_torch_tp import GLOBAL, MODEL, WORLD, _groups, _sample_cfg
from torch_dp_worker import JOIN_TIMEOUT, _run_rank, one_thread_children, spawn_world
from torch_tp_worker import rendezvous_rollout, tp_sampler_scenarios

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

MODES = {  # the sample_video knobs of each mode
    "kv8": {"kv_cache_dtype": "int8"},
    "kv8-pallas": {"kv_cache_dtype": "int8", "attn_impl": "pallas"},
    "kv8-live": {"kv_cache_dtype": "int8", "attn_impl": "pallas-live"},
    "w8": {"weight_dtype": "int8"},
    "w8-pallas": {"weight_dtype": "int8-pallas"},
    "kv8-mm8": {"kv_cache_dtype": "int8", "mm_dtype": "int8"},
    "kv8-pallas-w8-pallas-mm8": {"kv_cache_dtype": "int8", "attn_impl": "pallas",
                                 "weight_dtype": "int8-pallas", "mm_dtype": "int8"},
    "kv4": {"kv_cache_dtype": "int4"},
    "streams2": {"streams": 2},
    "kv8-pallas-streams2": {"kv_cache_dtype": "int8", "attn_impl": "pallas", "streams": 2},
    "kv8-live-streams2": {"kv_cache_dtype": "int8", "attn_impl": "pallas-live", "streams": 2},
}
EXACT = ("streams2",)  # native: bit-equal to lvt_tpu's
TEACHER = ("native", "int8", "int4")  # native: each mode's gap is measured against it
TEACHER_SLICE = {"native": {}, "w8": {"weight_dtype": "int8"},
                 "w8-pallas": {"weight_dtype": "int8-pallas"}}
KEY = 5  # lvt_tpu's rollout key (greedy draws nothing)


def _jax_model():
    m = JaxVT(_sample_cfg(jax_get_cfg), T=4, H=4, W=4)
    params, _ = _jax_tree_of_port_init(m, _sample_cfg(model=MODEL))
    return m, params


def _lvt_tpu_side(video):
    """lvt_tpu's greedy rollout of the 8 rows in each mode, the int8 + pallas
    one also on its (4, 2) mesh, and its teacher-forced logits in each
    kv_cache_dtype of TEACHER."""
    m, params = _jax_model()
    vj = jnp.asarray(video, jnp.int32)
    want = {"modes": {}, "teacher": {}}
    for name, knobs in MODES.items():
        want["modes"][name] = np.asarray(jax.jit(lambda p, vd, k, kn=knobs: m.sample_video(
            p, vd, k, n_prime=1, greedy=True, **kn))(params, vj, jax.random.key(KEY)))
    mesh = build_mesh(data=4, model=MODEL)
    knobs = MODES["kv8-pallas"]
    want["kv8-pallas (4, 2)"] = np.asarray(jax.jit(lambda p, vd, k: m.sample_video(
        p, vd, k, n_prime=1, greedy=True, **knobs))(
            jax_shard_tree(mesh, params), jax.device_put(vj, NamedSharding(mesh, P("data"))),
            jax.random.key(KEY)))
    for kv in TEACHER:
        want["teacher"][kv] = np.asarray(jax.jit(lambda p, vd, kv=kv: (
            m.logits_for_entire_video_incremental(p, vd, kv_cache_dtype=kv)))(params, vj))
    want["teacher_slice"] = {name: _jax_teacher_slice(m, params, video, knobs)
                             for name, knobs in TEACHER_SLICE.items()}
    return want


def _jax_teacher_slice(m, params, video, knobs):
    """lvt_tpu's teacher-forced logits of the middle slice of the 8 rows in
    the mode ``knobs``, from the port's slice inputs."""
    tm = VideoTransformer(_sample_cfg(), T=4, H=4, W=4)
    s = tm.plan.num_slices // 2
    sidx = torch.full((video.shape[0],), s, dtype=torch.int64)
    ctx, sl, _ = tm.prepare_slices(torch.from_numpy(video), sidx)
    n = sl[0, 0].numel()

    def side(netg, ctx, sl, sidx):
        zl = jax_vt_encode(netg, m.c, ctx, sidx, use_pallas=False)
        return jvti.sample_slice_incremental(netg, m.c, m.plan.slice_shape, zl, sl,
                                             jax.random.key(0), jnp.ones((n,), bool), 1.0,
                                             teacher_logits=True, **knobs)[2]

    return np.asarray(jax.jit(side)(params["netG"], jnp.asarray(ctx.numpy()),
                                    jnp.asarray(sl.numpy().astype(np.int32)),
                                    jnp.asarray(sidx.numpy().astype(np.int32))))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp_sampler"))
    video = np.random.default_rng(23).integers(0, 8, (GLOBAL, 2, 4, 4, 4)).astype(np.int64)
    payload = {"sample": {"cfg": _sample_cfg(model=MODEL), "video": video}, "modes": MODES,
               "teacher": TEACHER, "teacher_slice": TEACHER_SLICE}
    out = {}

    def spawn():
        try:
            out["res"] = spawn_world(tp_sampler_scenarios, payload, os.path.join(tmp, "ranks"),
                                     world=WORLD)
        except BaseException as e:  # raised again below, in the test's thread
            out["err"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        want = _lvt_tpu_side(video)
    finally:
        thread.join()
    if "err" in out:
        raise out["err"]
    return {"video": video, "want": want, "res": out["res"]}


def _gathered(res, pick):
    """The first rank of each model group's ``pick``, in data order, after
    asserting that the ranks of each group agree bit for bit."""
    for group in _groups():
        first, *rest = (pick(res[r]) for r in group)
        for other in rest:
            np.testing.assert_array_equal(other, first)
    return np.concatenate([pick(res[g[0]]) for g in _groups()])


@pytest.mark.parametrize("mode", list(MODES))
def test_tp_greedy_codes_in_every_sampler_mode(world, mode):
    got = _gathered(world["res"], lambda r: r["modes"][mode])
    want = world["want"]["modes"][mode]
    video = world["video"]
    assert got.shape == want.shape == video.shape
    assert got.min() >= 0 and got.max() < 8
    np.testing.assert_array_equal(got[:, :, :1], video[:, :, :1])  # the primed frame is kept
    if mode in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        assert float((got == want).mean()) >= 0.98, float((got == want).mean())


def test_lvt_tpus_tp_rollout_equals_its_replicated_one_with_int8_pallas(world):
    want = world["want"]
    np.testing.assert_array_equal(want["kv8-pallas (4, 2)"], want["modes"]["kv8-pallas"])


@pytest.mark.parametrize("what,mode", [("teacher", "int8"), ("teacher", "int4"),
                                       ("teacher_slice", "w8"), ("teacher_slice", "w8-pallas")])
def test_tp_teacher_logits_match_lvt_tpu_in_the_same_mode(world, what, mode):
    res = world["res"]
    got = _gathered(res, lambda r: r[what][mode]["logits"])
    native = _gathered(res, lambda r: r[what]["native"]["logits"])
    want = world["want"][what][mode]
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    gap = float(np.abs(got - native).max())
    assert gap >= 10 * LOGIT_TOL, f"the mode's own gap to native, {gap}, is too near the bound"
    margin = min(r[what][mode]["margin"] for r in res)
    if margin >= TIE_MARGIN:
        assert err <= LOGIT_TOL, (err, gap, margin)
    else:  # a near-tie may round one step apart: one step of the many that make the gap
        assert err <= 0.5 * gap, (err, gap, margin)


def test_row_split_int8_weights_are_the_whole_weights_rows(world):
    cfg = _sample_cfg(model=MODEL)
    vt = VideoTransformer(cfg, T=4, H=4, W=4)
    params, _ = vt.init(torch.Generator().manual_seed(cfg.SEED))
    layers = params["netG"]["decoder"]["layers"]
    for rank, r in enumerate(world["res"]):
        m = rank % MODEL
        for l, (lw, lp) in enumerate(zip(r["weights"], layers)):
            for name, leaf, dim in (("proj", "proj", 0), ("ffn2", "ffn_w2", 0),
                                    ("ffn1", "ffn_w1", 1)):
                wi, s = (t.numpy() for t in quantize_cols(lp[leaf], torch.float32))
                part = wi.shape[dim] // MODEL
                got_i, got_s = lw[name]
                want_i = np.take(wi, range(m * part, (m + 1) * part), axis=dim)
                np.testing.assert_array_equal(got_i, want_i, err_msg=f"rank {rank} {l} {name}")
                want_s = s if dim == 0 else s[m * part:(m + 1) * part]
                np.testing.assert_array_equal(got_s, want_s, err_msg=f"rank {rank} {l} {name}")
        # the rank's own rows would give other scales: the group's are in use
        own = quantize_cols(layers[0]["proj"][m * 16:(m + 1) * 16], torch.float32)[1]
        assert not np.array_equal(own.numpy(), r["weights"][0]["proj"][1])


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_a_row_split_int8_product_is_the_whole_product_bit_for_bit(world, dtype):
    """matmul_i8w_split on each rank's half of the rows (the group's row
    absmax and column scales, int32 sums added over the group, one
    epilogue) against matmul_i8w on the whole rows."""
    for r in world["res"]:
        got, want = r["split_product"][dtype]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["native", "int8"])
def test_a_row_split_bf16_product_is_rounded_once_after_the_sum(world, mode):
    """SliceDecoder's row-split product in bf16 (each rank's fp32 partial
    product, summed over the group, rounded once; with int8 weights then
    scaled) against the whole product rounded once: bit-equal but where the
    fp32 sums' order moves a value across a rounding boundary, and there
    within one bf16 ulp. Rounding each rank's partial product to bf16 before
    the sum moves far more of them."""
    for r in world["res"]:
        got, want = r["row_products"][mode]
        assert np.mean(got == want) >= 0.99, np.mean(got == want)
        assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want)).all(), np.abs(got - want).max()


def test_two_machines_rendezvous_with_model_groups_on_each(tmp_path):
    """engine.launch called once a machine (num_machines=2, machine_rank 0
    and 1, 2 processes each, one tcp:// address): ranks 2m and 2m + 1 are
    machine m's and form model group m, and the greedy rollout under them
    equals the world of one's."""
    from lvt_tpu_torch.engine.launch import _find_free_port, launch

    cfg = _sample_cfg(model=MODEL)
    video = np.random.default_rng(29).integers(0, 8, (GLOBAL, 2, 4, 4, 4)).astype(np.int64)
    payload = {"cfg": cfg, "video": video}
    url = f"tcp://127.0.0.1:{_find_free_port()}"
    out_dir = str(tmp_path)
    errors = []

    def machine(rank):
        try:
            launch(_run_rank, 2, num_machines=2, machine_rank=rank, dist_url=url,
                   backend="gloo", args=(rendezvous_rollout, pickle.dumps(payload), out_dir),
                   timeout=datetime.timedelta(seconds=JOIN_TIMEOUT), join_timeout=JOIN_TIMEOUT)
        except BaseException as e:  # raised again below, in the test's thread
            errors.append(e)

    with one_thread_children():
        threads = [threading.Thread(target=machine, args=(m,)) for m in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    res = []
    for r in range(WORLD):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    for r, got in enumerate(res):
        machine_ranks = [2 * (r // 2), 2 * (r // 2) + 1]
        assert got["machine"] == machine_ranks and got["model_group"] == machine_ranks, got
    codes = _gathered(res, lambda r: r["codes"])
    vt = VideoTransformer(cfg, T=4, H=4, W=4)
    params, _ = vt.init(torch.Generator().manual_seed(cfg.SEED))
    one = vt.sample_video(params, torch.from_numpy(video), n_prime=1, greedy=True).numpy()
    np.testing.assert_array_equal(codes, one)
