"""The port's spatial parallelism (TPU.SHARD_SPATIAL) held to lvt_tpu on the
CPU. One world of 4 gloo processes, data 2 x model 2 (TPU.MESH_MODEL 2),
spawned once for the module through engine.launch (tests/torch_sp_worker.py),
runs every scenario; lvt_tpu runs beside it in this process on the 8-device
CPU mesh of tests/conftest.py.

* (a) Each op on bands of rows (8 of 16 rows a rank) against the same op on
  the whole tensor: forward, input gradient and weight gradient (summed over
  the model group), fp32, max relative error <= 1e-5: ``conv2d`` at k3 s1
  p1, k4 s2 p1 and k1, ``conv_transpose2d`` at k4 s2 p1, avgpool, upsample,
  pixelshuffle, and every norm of ``VALID_NORMS`` in train mode (a batch
  norm's running statistics too).
* (b) lvt_tpu's own scenario, tests/test_tp.py:140-189: PR-DVQVAE2 at NF 16,
  RES 8, 1 layer, DIM 16, global batch 8 of 16 x 16 frames, 2 fp32 steps,
  against lvt_tpu's Trainer with TPU.SHARD_SPATIAL on its (4, 2) mesh from
  the same weights (the port's init, carried over by the converters) and
  images, and against the port's one-process trainer: losses at rtol 1e-4,
  every gathered parameter and EMA buffer at rtol 1e-3 / atol 5e-5 (that
  test's bounds); indices of step 1 by the near-tie rule of ``ops/vq.py``.
  The codebook is split over its 512 codes as well.
* (c) The same with Base-VQVAE's single codebook, and with
  MODEL.ENCODER.NORM "BN" and a codebook of 511 codes, which the model
  group does not divide: whole on every rank, as in lvt_tpu.
* (d) The rows are split: each rank quantizes 2 of the 4 latent rows, and
  a step makes 8 halo exchanges forward and 7 backward (the first
  convolution's input needs no gradient). An ``image_sequence`` batch and a
  VT batch under the key give the step without it, bit for bit.
* (e) tools/train_net_torch.py trains 2 steps in the world with
  TPU.MESH_MODEL 2 TPU.SHARD_SPATIAL True; its checkpoint resumes in a world
  of one (this process) at step 2, within (b)'s bounds of the world of one's
  own 2 steps on the same frames. --eval-only under the key splits no rows:
  the world's MSE is the world of one's on the same checkpoint (rtol 1e-3,
  tests/test_torch_tp.py's bound for a sharded evaluation).
* (f) A height that does not split raises ValueError: 15 rows over 2 bands,
  and bands of 9 rows under a stride-2 convolution.
"""

import os
import shutil
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu.config import get_cfg as jax_get_cfg
from lvt_tpu.engine.trainer import Trainer as JaxTrainer
from lvt_tpu.engine.trainer import TrainState
from lvt_tpu.ops.vq import encode_indices as jax_encode_indices
from lvt_tpu.parallel.mesh import build_mesh
from lvt_tpu_torch.config import get_cfg
from lvt_tpu_torch.engine.trainer import Trainer
from lvt_tpu_torch.ops.vq import index_differences
from test_torch_data_parallel import _cli_payload, _jax_tree_of_port_init, _write_cli_data
from test_torch_tp import _np_flat, _vt_cfg
from test_torch_train import H, T, W
from test_torch_vqvae_train import _port_trees
from torch_dp_worker import spawn_world
from torch_sp_worker import op_cases, sp_scenarios

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, MODEL = 4, 2  # data 2 x model 2
GLOBAL, STEPS = 8, 2
RTOL, ATOL = 1e-3, 5e-5  # tests/test_tp.py:188-189
OP_RTOL = 1e-5
LATENT_ROWS = 4  # 16 rows / 4


def _sp_cfg(get=get_cfg, base="PR-DVQVAE2", norm="", size=512, shard=True, model=MODEL,
            out=""):
    """tests/test_tp.py:140-189's narrow VQ-VAE of ``base``.yaml, fp32."""
    cfg = get()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "vqvae", base + ".yaml"))
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.SHARD_SPATIAL = shard
    cfg.TPU.MESH_MODEL = model
    m = cfg.MODEL
    m.ENCODER.IN_CHANNELS = 3
    m.ENCODER.NF = m.GENERATOR.NF = 16
    m.ENCODER.RES_CHANNELS = m.GENERATOR.RES_CHANNELS = 8
    m.ENCODER.N_LAYERS = m.GENERATOR.N_LAYERS = 1
    m.GENERATOR.IN_CHANNELS = m.CODEBOOK.DIM = 16
    m.ENCODER.NORM = norm
    m.CODEBOOK.SIZE = size
    cfg.SOLVER.IMS_PER_BATCH = GLOBAL
    cfg.SEED = 2
    cfg.OUTPUT_DIR = out
    return cfg


VQ_RUNS = {"prd": {}, "base": {"base": "Base-VQVAE"}, "bn": {"norm": "BN", "size": 511}}


# --------------------------------------------------------------------------
# lvt_tpu's side: its Trainer with TPU.SHARD_SPATIAL over the (4, 2) mesh
# --------------------------------------------------------------------------

def _jax_sp_steps(kw, port_cfg, batches, out):
    """lvt_tpu's Trainer with TPU.SHARD_SPATIAL on its (4, 2) mesh from the
    port's init of ``port_cfg``: [(metrics, params, state) in the port's
    names after each step], and the first batch's z and indices before step
    1, as ``encode`` finds them and as the step does (train-mode norms), with
    the codebook."""
    tr = JaxTrainer(_sp_cfg(jax_get_cfg, out=out, **kw), iter(()),
                    mesh=build_mesh(data=4, model=MODEL))
    jp, js = _jax_tree_of_port_init(tr.model, port_cfg)
    tr.state = tr._place_state(TrainState(params=jp, model_state=js,
                                          opt_state=tr.optimizer.init(jp), accum_grads=None,
                                          step=jnp.zeros((), jnp.int32)))
    jm = tr.model
    x = jm.normalize(jnp.asarray(batches[0]["image"]))
    z_step = jm.encode_features(jp, js, x, train=True)[0]
    first = {"encode_indices": np.asarray(jm.encode(jp, js, x)),
             "encode_z": np.asarray(jm.encode_features(jp, js, x)[0]),
             "step_indices": np.asarray(jax_encode_indices(z_step, js["netC"])),
             "step_z": np.asarray(z_step), "codebook": np.asarray(js["netC"].embedding)}
    steps = []
    for b in batches:
        tr.state, metrics = tr._train_step(tr.state, tr._put_batch(b), tr._step_key)
        params, mstate = _port_trees(tr.state.params, tr.state.model_state)
        steps.append(({k: float(v) for k, v in metrics.items()}, _np_flat(params),
                      _np_flat(mstate)))
    return steps, first


def _one_process_steps(cfg, batches):
    """The port's trainer in this process (no world) on the whole batches."""
    tr = Trainer(cfg, iter(()), device="cpu")
    metrics = [{k: float(v) for k, v in tr.train_step(tr._put_batch(b)).items()}
               for b in batches]
    return metrics, _np_flat(tr.state.params), _np_flat(tr.state.model_state)


# --------------------------------------------------------------------------
# The world
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sp"))
    rng = np.random.default_rng(22)
    images = [{"image": rng.random((GLOBAL, 16, 16, 3)).astype(np.float32)}
              for _ in range(STEPS)]
    sequences = [{"image_sequence": rng.random((GLOBAL, 2, 16, 16, 3)).astype(np.float32)}]
    videos = [{"video": rng.integers(0, 64, (GLOBAL, 4, T, H, W)).astype(np.int32)}]
    si = [rng.integers(0, 4, (GLOBAL,)).astype(np.int64)]
    _write_cli_data(tmp, rng)
    cli = _cli_payload(tmp)
    cli = {"argv": cli["argv"]["vq"] + ["TPU.MESH_MODEL", str(MODEL), "TPU.SHARD_SPATIAL",
                                        "True"], "datasets": cli["datasets"]}
    payload = {
        "ops": {"cfg": _sp_cfg(), "cases": op_cases(rng)},
        "vq": {name: {"cfg": _sp_cfg(**kw), "batches": images} for name, kw in VQ_RUNS.items()},
        "whole": {"sequence": {"cfg": _sp_cfg(), "batches": sequences, "si": None},
                  "vt": {"cfg": _vt_cfg(model=MODEL), "batches": videos, "si": si}},
        "refusals": {"cfg": _sp_cfg(), "images": {
            "15 rows": rng.random((GLOBAL, 15, 16, 3)).astype(np.float32),
            "bands of 9 rows": rng.random((GLOBAL, 18, 16, 3)).astype(np.float32)}},
        "cli": cli,
    }
    world = {}

    def spawn():
        try:
            world["res"] = spawn_world(sp_scenarios, payload, os.path.join(tmp, "ranks"),
                                       world=WORLD)
        except BaseException as e:  # raised again below, in the test's thread
            world["err"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    want, one = {}, {}
    try:
        for name, kw in VQ_RUNS.items():
            want[name] = _jax_sp_steps(kw, payload["vq"][name]["cfg"], images,
                                       os.path.join(tmp, "jax_" + name))
        one["prd"] = _one_process_steps(_sp_cfg(shard=False, model=1), images)
    finally:
        thread.join()
    if "err" in world:
        raise world["err"]
    return {"payload": payload, "want": want, "one": one, "res": world["res"], "tmp": tmp}


def _close(got, want, what):
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=ATOL, err_msg=f"{what}: {k}")


def _groups():
    """The ranks of each model group: (0, 1) and (2, 3)."""
    return [list(range(d * MODEL, (d + 1) * MODEL)) for d in range(WORLD // MODEL)]


# --------------------------------------------------------------------------
# (a) The ops
# --------------------------------------------------------------------------

def _op_names():
    return [c["name"] for c in op_cases(np.random.default_rng(0), data=1)]


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", _op_names())
def test_op_on_bands_of_rows_equals_the_whole_op(sp, name):
    for r in sp["res"]:
        got = r["ops"][name]
        assert got is not None, name
        for part in ("y", "dx", "dw"):
            if got[part] is None:
                continue
            band, whole = got[part]
            assert band.shape == whole.shape, (name, part, band.shape, whole.shape)
            assert _rel(band, whole) <= OP_RTOL, (name, part, r["rank"], _rel(band, whole))
        for k, (band, whole) in (got["state"] or {}).items():
            assert _rel(band, whole) <= OP_RTOL, (name, k, r["rank"])
    if name.startswith("conv"):  # the weight's gradient was held
        assert sp["res"][0]["ops"][name]["dw"] is not None


def test_gather_rows_makes_the_frames_whole_on_every_rank(sp):
    for r in sp["res"]:
        got, want = r["ops"]["gather_rows"]
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# (b), (c) Steps against lvt_tpu's and the one-process trainer's
# --------------------------------------------------------------------------

def _global_metrics(sp, name):
    """Each step's metrics of the global batch: the model groups' frames'
    means (equal in number), averaged; the ranks of a group agree."""
    res = sp["res"]
    for g in _groups():
        assert all(res[r][name]["metrics"] == res[g[0]][name]["metrics"] for r in g)
    per = [res[g[0]][name]["metrics"] for g in _groups()]
    return [{k: float(np.mean([p[i][k] for p in per])) for k in per[0][i]}
            for i in range(len(per[0]))]


@pytest.mark.parametrize("name", list(VQ_RUNS))
def test_row_sharded_steps_match_lvt_tpus_spatial_step(sp, name):
    steps, _ = sp["want"][name]
    got = _global_metrics(sp, name)
    for i, (metrics, _, _) in enumerate(steps):
        assert set(got[i]) == set(metrics)
        for k, w in metrics.items():
            np.testing.assert_allclose(got[i][k], w, rtol=1e-4,
                                       err_msg=f"{name} step {i + 1}: {k}")
    for r in sp["res"]:
        _close(r[name]["params"], steps[-1][1], f"{name} rank {r['rank']} params")
        _close(r[name]["state"], steps[-1][2], f"{name} rank {r['rank']} model state")


def test_row_sharded_step_matches_the_one_process_trainer(sp):
    metrics, params, state = sp["one"]["prd"]
    got = _global_metrics(sp, "prd")
    for i, m in enumerate(metrics):
        for k, w in m.items():
            np.testing.assert_allclose(got[i][k], w, rtol=1e-4, err_msg=k)
    for r in sp["res"]:
        got = r["prd"]
        _close(got["params"], params, f"rank {r['rank']} params vs one process")
        _close(got["state"], state, f"rank {r['rank']} model state vs one process")


@pytest.mark.parametrize("name", list(VQ_RUNS))
@pytest.mark.parametrize("path", ["step_indices", "encode_indices"])
def test_row_sharded_indices_equal_lvt_tpus_up_to_near_ties(sp, name, path):
    _, first = sp["want"][name]
    res = sp["res"]
    # the bands of each model group side by side, the data groups' rows after each other
    got = np.concatenate([np.concatenate([res[r][name][path] for r in g], axis=1)
                          for g in _groups()])
    want = first[path]
    assert got.shape == want.shape, (got.shape, want.shape)
    num = got.shape[-1]
    z = torch.from_numpy(first[path.replace("indices", "z")].copy()).reshape(-1, num, 16 // num)
    n_diff, n_far = index_differences(torch.from_numpy(got).reshape(-1, num),
                                      torch.from_numpy(want.copy()).reshape(-1, num), z,
                                      torch.from_numpy(first["codebook"].copy()))
    assert n_far == 0 and n_diff <= 1e-3 * got.size, (n_diff, n_far)


# --------------------------------------------------------------------------
# (d) The rows are split; other batches are not
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(VQ_RUNS))
def test_each_rank_holds_its_band_and_exchanges_halos(sp, name):
    for r in sp["res"]:
        got = r[name]
        assert got["band"] == (GLOBAL // 2, 16 // MODEL, 16, 3)
        assert [s[1] for s in got["z_shapes"]] == [LATENT_ROWS // MODEL] * STEPS, got["z_shapes"]
        # encoder 3 convolutions + 1 resblock's 3 x 3, decoder 1 + 1 + 2
        # transposed: 8; the first convolution's input needs no gradient
        assert got["halos"] == [{"forward": 8, "backward": 7}] * STEPS, got["halos"]
    local = {name: r["local_state"]["netC.embedding"].shape
             for name, r in sp["res"][0].items() if name in VQ_RUNS}
    # the codebook split over its codes too, unless the group does not divide them
    assert local == {"prd": (4, 512 // MODEL, 4), "base": (1, 512 // MODEL, 16),
                     "bn": (4, 511, 4)}


@pytest.mark.parametrize("name", ["sequence", "vt"])
def test_batches_the_key_leaves_whole_step_as_without_it(sp, name):
    for r in sp["res"]:
        (p_sp, s_sp), (p_no, s_no) = r["whole"][name]
        assert set(p_sp) == set(p_no) and set(s_sp) == set(s_no)
        for k in p_no:
            np.testing.assert_array_equal(p_sp[k], p_no[k], err_msg=k)
        for k in s_no:
            np.testing.assert_array_equal(s_sp[k], s_no[k], err_msg=k)


# --------------------------------------------------------------------------
# (e) The training CLI and a resume in a world of one
# --------------------------------------------------------------------------

def test_the_cli_trains_row_sharded_and_resumes_in_a_world_of_one(sp):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_net_torch
    from lvt_tpu_torch.data.catalog import DatasetCatalog
    from lvt_tpu_torch.engine.defaults import default_argument_parser

    res = [r["cli"] for r in sp["res"]]
    assert all(r["step"] == 2 and r["rows"] for r in res)
    assert res[0]["state"]["netC.embedding"] == (4, 512 // MODEL, 4)
    assert all(r["eval"] == {} for r in res[1:])  # rank 0 reports
    cli = sp["payload"]["cli"]
    for name, fn in cli["datasets"].items():
        DatasetCatalog._REGISTERED.pop(name, None)
        DatasetCatalog.register(name, fn)
    argv = cli["argv"][:cli["argv"].index("TPU.MESH_MODEL")]
    out = argv[argv.index("OUTPUT_DIR") + 1]
    one_dir = out + "_one"
    argv = argv[:argv.index("OUTPUT_DIR")] + ["OUTPUT_DIR", one_dir]
    parse = default_argument_parser().parse_args
    one = train_net_torch.main(parse(argv + ["SOLVER.MAX_ITER", "2"]), device="cpu")
    resumed = Trainer(train_net_torch.load_cfg(parse(argv[:-1] + [out])), iter(()),
                      device="cpu")
    assert resumed.resume_or_load(resume=True) == 2
    _close(_np_flat(resumed.state.params), _np_flat(one.state.params), "params resumed")
    _close(_np_flat(resumed.state.model_state), _np_flat(one.state.model_state),
           "model state resumed")
    shutil.rmtree(one_dir, ignore_errors=True)
    # the world's checkpoint evaluated by a world of one, without the key
    shutil.copytree(out, one_dir, ignore=shutil.ignore_patterns("inference"))
    want = train_net_torch.main(parse(["--eval-only"] + argv), device="cpu")
    np.testing.assert_allclose(res[0]["eval"]["reconstruction"]["MSE"],
                               want["reconstruction"]["MSE"], rtol=1e-3)
    shutil.rmtree(one_dir, ignore_errors=True)


# --------------------------------------------------------------------------
# (f) Heights that do not split
# --------------------------------------------------------------------------

def test_a_height_that_does_not_split_raises(sp):
    for r in sp["res"]:
        got = r["refusals"]
        assert got["15 rows"] is not None and "15 rows does not split into 2" \
            in got["15 rows"][1], got
        assert got["bands of 9 rows"] is not None and "is not a multiple of the stride 2" \
            in got["bands of 9 rows"][1], got
