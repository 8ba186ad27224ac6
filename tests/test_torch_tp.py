"""The port's tensor parallelism held to lvt_tpu on the CPU. One world of 4
gloo processes, data 2 x model 2 (TPU.MESH_MODEL 2), spawned once for the
module through engine.launch (tests/torch_tp_worker.py), runs every
scenario; lvt_tpu runs beside it in this process on the 8-device CPU mesh of
tests/conftest.py.

* (a) The port's ``tp_dim`` against lvt_tpu's ``tp_spec`` at a model axis of
  2, on every leaf of tests/test_tp.py's tiny VT, of its RMSprop state and
  of an ``init_codebook`` codebook; the guards of tests/test_tp.py:112.
* (b) Two fp32 RMSprop steps of that VT at global batch 8 (4 rows a data
  rank) against lvt_tpu's step over its (8, 1) mesh from the same weights,
  batches and slice indices: losses at rtol 1e-4, every gathered parameter
  at rtol 1e-3 / atol 5e-5 (the bounds of tests/test_tp.py:80-91). The split
  leaves are halved on each rank; the replicated leaves are bit-equal
  across a model group.
* (c) Greedy ``sample_video`` of tests/test_multichip_sampling.py's tiny VT:
  codes bit-equal to lvt_tpu's greedy rollout on the same weights, and
  equal on the two ranks of each model group.
* (d) A PR-DVQVAE2 step at tests/test_tp.py's sizes with the codebook split
  over its 512 codes, against lvt_tpu's step: loss, params and EMA state at
  (b)'s bounds; the indices by the near-tie rule (ops/vq.py).
* (e) Checkpoints across layouts: saved after step 1 in the world and
  resumed in a world of one (this process), and saved by a world of one and
  resumed in the world; the next step within (b)'s bounds of the unbroken
  run. A resume in the same layout is bit-equal.
* (f) The refusals: a model axis that does not divide the world, the
  generation script's model axis; TPU.SHARD_SPATIAL is accepted
  (tests/test_torch_sp.py holds it). Every sampler mode under the model
  group: tests/test_torch_tp_sampler.py.
* tools/train_net_torch.py's main in the world with TPU.MESH_MODEL 2: the
  narrow VQ-VAE and VT of tests/test_torch_data_parallel.py train 2 steps,
  split, and --eval-only there gives the world of one's bits/dim (1e-6) and
  MSE, and its latents up to near-ties (1 in 1,000).
"""

import os
import shutil
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from lvt_tpu.config import get_cfg as jax_get_cfg
from lvt_tpu.engine.trainer import TrainState, make_train_step
from lvt_tpu.models import build_model as jax_build_model
from lvt_tpu.models.vt import VideoTransformer as JaxVT
from lvt_tpu.ops.vq import init_codebook as jax_init_codebook
from lvt_tpu.parallel.mesh import build_mesh, replicated, shard_batch
from lvt_tpu.parallel.sharding import tp_spec
from lvt_tpu.solver.build import build_optimizer as jax_build_optimizer
from lvt_tpu_torch.checkpoint.convert import flatten
from lvt_tpu_torch.config import get_cfg
from lvt_tpu_torch.engine.trainer import Trainer
from lvt_tpu_torch.models.vt import VideoTransformer
from lvt_tpu_torch.ops.vq import index_differences
from lvt_tpu_torch.ops.vq import init_codebook as port_init_codebook
from lvt_tpu_torch.parallel import mesh as tmesh
from lvt_tpu_torch.parallel.sharding import sharded_field_names, tp_dim, tp_dims
from test_torch_data_parallel import _cli_payload, _jax_tree_of_port_init, _write_cli_data
from test_torch_train import H, T, W, _to_port
from test_torch_vqvae_train import _port_trees
from torch_dp_worker import spawn_world
from torch_tp_worker import tp_scenarios

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, MODEL = 4, 2  # data 2 x model 2
GLOBAL = 8  # global batch: 4 rows a data rank, 1 on each of lvt_tpu's 8 devices
STEPS = 2
RTOL, ATOL = 1e-3, 5e-5  # tests/test_tp.py:80-91


def _vt_cfg(get=get_cfg, model=1, out=""):
    """tests/test_tp.py's _vt_cfg; the unfused layers, as lvt_tpu runs them
    on the CPU."""
    cfg = get()
    cfg.MODEL.META_ARCHITECTURE = "VideoTransformerModel"
    cfg.MODEL.AUTOREGRESSIVE.NAME = "VideoTransformer"
    v = cfg.MODEL.AUTOREGRESSIVE.VT
    v.NC, v.NV = 4, 64
    v.KERNEL, v.STRIDE = (3, 1, 1), (4, 1, 1)
    v.D, v.DA, v.DE = 64, 32, 32
    v.BLOCKS_E = ((1, 4, 4),) * 2
    v.N_HEAD_E = (2, 2)
    v.BLOCKS_D = ((1, 4, 4),) * 2
    v.N_HEAD_D = (2, 2)
    v.N_PRIME = 1
    v.SHARE_P = False
    cfg.INPUT.SCALE_TO_ZEROONE = False
    cfg.SOLVER.IMS_PER_BATCH = GLOBAL
    cfg.SOLVER.OPTIMIZER_NAME = "rmsprop"
    cfg.SOLVER.RMSPROP.ALPHA_G = 0.95
    cfg.SOLVER.RMSPROP.MOMENTUM_G = 0.9
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.FUSED_LAYER = False
    cfg.TPU.MESH_MODEL = model
    cfg.OUTPUT_DIR = out
    cfg.SEED = 3
    return cfg


def _sample_cfg(get=get_cfg, model=1):
    """tests/test_multichip_sampling.py's _tiny_vt."""
    cfg = get()
    cfg.MODEL.META_ARCHITECTURE = "VideoTransformerModel"
    cfg.MODEL.AUTOREGRESSIVE.NAME = "VideoTransformer"
    v = cfg.MODEL.AUTOREGRESSIVE.VT
    v.NC, v.NV = 2, 8
    v.KERNEL, v.STRIDE = (3, 1, 1), (4, 1, 1)
    v.D, v.DA, v.DE = 32, 16, 16
    v.BLOCKS_E = ((1, 4, 4),) * 2
    v.N_HEAD_E = (2, 2)
    v.BLOCKS_D = ((1, 4, 4),) * 2
    v.N_HEAD_D = (2, 2)
    v.N_PRIME = 1
    v.SHARE_P = False
    cfg.TPU.MESH_MODEL = model
    cfg.SEED = 5
    return cfg


def _vq_cfg(get=get_cfg, model=1):
    """tests/test_tp.py:125-150's PR-DVQVAE2 (4 sub-codebooks of 512 codes
    of 4), fp32."""
    cfg = get()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "vqvae", "PR-DVQVAE2.yaml"))
    cfg.TPU.COMPUTE_DTYPE = "float32"
    m = cfg.MODEL
    m.ENCODER.NF = m.GENERATOR.NF = 16
    m.ENCODER.RES_CHANNELS = m.GENERATOR.RES_CHANNELS = 8
    m.ENCODER.N_LAYERS = m.GENERATOR.N_LAYERS = 1
    m.GENERATOR.IN_CHANNELS = m.CODEBOOK.DIM = 16
    cfg.SOLVER.IMS_PER_BATCH = GLOBAL
    cfg.TPU.MESH_MODEL = model
    cfg.SEED = 2
    return cfg


def _si_trainer(cfg, batches_si):
    """A world-of-one Trainer whose slice draws are ``batches_si``."""
    tr = Trainer(cfg, iter(()), device="cpu")
    draws = iter(batches_si)
    tr.model.sample_train_slice_idx = lambda gen, b, T=None: torch.from_numpy(next(draws))
    return tr


def _step(tr, batch):
    return {k: float(v) for k, v in tr.train_step(tr._put_batch(batch)).items()}


def _np_flat(tree):
    return {k: v.detach().numpy().copy() for k, v in flatten(tree).items()}


# --------------------------------------------------------------------------
# lvt_tpu's side: its replicated step over the (8, 1) mesh
# --------------------------------------------------------------------------

def _jax_steps(jm, port_cfg, batches, si=None):
    """lvt_tpu's jitted train step over its (8, 1) data mesh from the port's
    init of ``port_cfg``: (init params, init state, [(metrics, params,
    state) in the port's names after each step])."""
    jp, js = _jax_tree_of_port_init(jm, port_cfg)
    opt = jax_build_optimizer(jm.cfg)
    mesh = build_mesh(data=8, model=1)
    if si is not None:  # the slice indices ride the batch, sharded with it
        def train_loss(p, mstate, batch, rng):
            loss, metrics = JaxVT.loss(jm, p, {"video": batch["video"]}, rng,
                                       slice_idx=batch["si"])
            return loss, (metrics, mstate)

        jm.train_loss = train_loss
    state = jax.device_put(TrainState(jp, js, opt.init(jp), None, jnp.zeros((), jnp.int32)),
                           replicated(mesh))
    step = jax.jit(make_train_step(jm, opt, 1))
    out = []
    for i, b in enumerate(batches):
        batch = dict(b) if si is None else dict(b, si=si[i].astype(np.int32))
        state, metrics = step(state, shard_batch(mesh, batch), jax.random.key(0))
        if si is not None:
            params, mstate = {"netG": _to_port(state.params["netG"])}, {}
        else:
            params, mstate = _port_trees(state.params, state.model_state)
        out.append(({k: float(v) for k, v in metrics.items()}, _np_flat(params),
                    _np_flat(mstate)))
    return jp, js, out


def _lvt_tpu_side(runs):
    """Everything lvt_tpu computes for the tests, while the world runs."""
    want = {}
    tr = runs["train"]
    _, _, want["train"] = _jax_steps(JaxVT(_vt_cfg(jax_get_cfg), T=T, H=H, W=W),
                                     tr["cfg"], tr["batches"], tr["si"])
    s = runs["sample"]
    m = JaxVT(_sample_cfg(jax_get_cfg), T=4, H=4, W=4)
    params, _ = _jax_tree_of_port_init(m, s["cfg"])
    want["sample"] = np.asarray(jax.jit(lambda p, vd, k: m.sample_video(
        p, vd, k, n_prime=1, greedy=True))(params, jnp.asarray(s["video"], jnp.int32),
                                           jax.random.key(5)))
    v = runs["vq"]
    jm = jax_build_model(_vq_cfg(jax_get_cfg))
    jp, js, want["vq"] = _jax_steps(jm, v["cfg"], v["batches"])
    x = jm.normalize(jnp.asarray(v["batches"][0]["image"]))
    want["vq_indices"] = np.asarray(jm.encode(jp, js, x))
    want["vq_z"] = np.asarray(jm.encode_features(jp, js, x)[0])
    want["vq_codebook"] = np.asarray(js["netC"].embedding)
    return want


# --------------------------------------------------------------------------
# The world
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp"))
    rng = np.random.default_rng(19)
    batches = [{"video": rng.integers(0, 64, (GLOBAL, 4, T, H, W)).astype(np.int32)}
               for _ in range(STEPS)]
    si = [rng.integers(0, 4, (GLOBAL,)).astype(np.int64) for _ in range(STEPS)]
    sample_cfg = _sample_cfg(model=MODEL)
    runs = {
        "train": {"cfg": _vt_cfg(model=MODEL), "batches": batches, "si": si},
        "sample": {"cfg": sample_cfg,
                   "video": rng.integers(0, 8, (GLOBAL, 2, 4, 4, 4)).astype(np.int64)},
        "vq": {"cfg": _vq_cfg(model=MODEL), "batches": [
            {"image": rng.uniform(0, 1, (GLOBAL, 16, 16, 3)).astype(np.float32)}]},
        "resume": {"cfg": _vt_cfg(model=MODEL, out=os.path.join(tmp, "saved_in_world")),
                   "batches": batches, "si": si, "one_dir": os.path.join(tmp, "saved_by_one")},
        "cli": _tp_cli_payload(tmp, rng),
    }
    # a world of one saves after step 1, for the world to resume, and steps on
    one = _si_trainer(_vt_cfg(out=runs["resume"]["one_dir"]), si)
    from lvt_tpu_torch.checkpoint import save_checkpoint
    _step(one, batches[0])
    save_checkpoint(one.cfg.OUTPUT_DIR, 1, one.checkpoint_tree())
    _step(one, batches[1])
    one_unbroken = _np_flat(one.state.params)

    world = {}

    def spawn():
        try:
            world["res"] = spawn_world(tp_scenarios, runs, os.path.join(tmp, "ranks"),
                                       world=WORLD)
        except BaseException as e:  # raised again below, in the test's thread
            world["err"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        want = _lvt_tpu_side(runs)
    finally:
        thread.join()
    if "err" in world:
        raise world["err"]
    return {"runs": runs, "want": want, "res": world["res"], "one_unbroken": one_unbroken}


def _tp_cli_payload(tmp, rng):
    """tests/test_torch_data_parallel.py's CLI runs with TPU.MESH_MODEL 2."""
    _write_cli_data(tmp, rng)
    cli = _cli_payload(tmp)
    cli["argv"] = {k: v + ["TPU.MESH_MODEL", str(MODEL)] for k, v in cli["argv"].items()}
    return cli


def _close(got, want, what):
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=ATOL, err_msg=f"{what}: {k}")


def _groups():
    """The ranks of each model group: (0, 1) and (2, 3)."""
    return [list(range(d * MODEL, (d + 1) * MODEL)) for d in range(WORLD // MODEL)]


# --------------------------------------------------------------------------
# (a) The rules against lvt_tpu's
# --------------------------------------------------------------------------

def _spec_dim(spec):
    return None if spec == P() else list(spec).index("model")


def _jax_dims(tree):
    mesh = build_mesh(data=4, model=MODEL)
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", None))))
                     for k in path): _spec_dim(tp_spec(mesh, path, leaf))
            for path, leaf in leaves}


def test_tp_dim_matches_tp_spec_on_the_vt_its_rmsprop_state_and_a_codebook():
    cfg = _vt_cfg()
    params, _ = VideoTransformer(cfg, T=T, H=H, W=W).init(torch.Generator().manual_seed(3))
    port = flatten(tp_dims(params, MODEL))
    jm = JaxVT(_vt_cfg(jax_get_cfg), T=T, H=H, W=W)
    shapes = jax.eval_shape(jm.init, jax.random.key(0))[0]
    want = _jax_dims(shapes)
    assert set(port) == set(want)
    assert port == want
    split = {k for k, d in port.items() if d is not None}
    assert {k.split(".")[-1] if not k.split(".")[-1].isdigit() else k.split(".")[-2]
            for k in split} >= {"wq", "wk", "wv", "proj", "ffn_w1", "ffn_b1", "ffn_w2",
                                "dt_bank", "dh_bank", "dw_bank", "ch_embed", "ctx_table",
                                "slice_embedding", "U_w", "U_b", "P_w"}
    # RMSprop's moments: each params-shaped leaf of lvt_tpu's optimizer state
    # has the split of the parameter it belongs to, which the port's
    # trainer gives that parameter's moments
    opt = jax_build_optimizer(jm.cfg)
    moments = {k: d for k, d in _jax_dims(jax.eval_shape(opt.init, shapes)).items()
               if "netG." in k}
    assert len(moments) == 2 * len(port)  # v and buf
    for k, d in moments.items():
        assert d == port[k[k.index("netG."):]], k
    # the EMA codebook, split over its codes
    cb = port_init_codebook(torch.Generator().manual_seed(0), 2, 64, 16)
    jcb = jax_init_codebook(jax.random.key(0), num=2, K=64, D=16)
    assert flatten(tp_dims(cb, MODEL)) == _jax_dims(jcb._asdict())
    assert sharded_field_names(cb, MODEL) == {"embedding", "running_sum", "running_size"}


@pytest.mark.parametrize("field, shape, size", [("wq", (3, 8, 4), MODEL),  # na = 3
                                                ("wq", (4, 8), MODEL),  # a rank mismatch
                                                ("wq", (4, 8, 4), 1),  # no model axis
                                                ("wq", (4, 8, 4), MODEL)])
def test_the_guards_match_lvt_tpus(field, shape, size):
    class Key:
        key = field

    want = _spec_dim(tp_spec(build_mesh(data=8 // size, model=size), (Key(),), np.zeros(shape)))
    assert tp_dim(field, shape, size) == want
    assert (want is None) == (shape != (4, 8, 4) or size == 1)


# --------------------------------------------------------------------------
# (b) Training
# --------------------------------------------------------------------------

def test_tp_steps_match_lvt_tpus_replicated_step(tp):
    want = tp["want"]["train"]
    for r in tp["res"]:
        got = r["train"]
        np.testing.assert_allclose(got["losses"], [m["loss_cross_entropy"] for m, _, _ in want],
                                   rtol=1e-4)
        _close(got["whole"], want[-1][1], f"rank {r['rank']} params after {STEPS} steps")


def test_split_leaves_are_split_and_replicated_leaves_bit_equal(tp):
    whole = tp["res"][0]["train"]["whole"]
    dims = {k: tp_dim(k.split(".")[-2] if k.split(".")[-1].isdigit() else k.split(".")[-1],
                      v.shape, MODEL) for k, v in whole.items()}
    assert sum(d is not None for d in dims.values()) > len(dims) // 2
    for group in _groups():
        parts = [tp["res"][r]["train"]["local"] for r in group]
        for k, d in dims.items():
            shapes = {p[k].shape for p in parts}
            if d is None:
                for p in parts[1:]:
                    np.testing.assert_array_equal(p[k], parts[0][k], err_msg=k)
                assert shapes == {whole[k].shape}, k
            else:
                half = list(whole[k].shape)
                half[d] //= MODEL
                assert shapes == {tuple(half)}, (k, shapes)
                np.testing.assert_array_equal(np.concatenate([p[k] for p in parts], axis=d),
                                              whole[k], err_msg=k)


# --------------------------------------------------------------------------
# (c) The greedy rollout
# --------------------------------------------------------------------------

def test_tp_greedy_rollout_equals_lvt_tpus(tp):
    want = tp["want"]["sample"]
    res = tp["res"]
    for group in _groups():
        a, b = (res[r]["sample"]["codes"] for r in group)
        np.testing.assert_array_equal(a, b)  # the ranks of a model group sample alike
    got = np.concatenate([res[g[0]]["sample"]["codes"] for g in _groups()])
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert all(r["sample"]["wq"] == (1, 32, 16) for r in res)  # 2 heads, 1 a rank


# --------------------------------------------------------------------------
# (d) The VQ-VAE with its codebook split over K
# --------------------------------------------------------------------------

def test_tp_vqvae_step_matches_lvt_tpu(tp):
    metrics, params, state = tp["want"]["vq"][0]
    for r in tp["res"]:
        got = r["vq"]
        _close(got["params"], params, f"rank {r['rank']} params")
        _close(got["state"], state, f"rank {r['rank']} EMA state")
        k = "netC.embedding"
        assert got["local_state"][k].shape == (4, 512 // MODEL, 4)
    # each data rank's loss is its rows' mean; the rows are equal in number
    for name, w in metrics.items():
        got = np.mean([tp["res"][g[0]]["vq"]["metrics"][0][name] for g in _groups()])
        np.testing.assert_allclose(got, w, rtol=1e-4, err_msg=name)


def test_tp_vqvae_indices_equal_lvt_tpus_up_to_near_ties(tp):
    want = tp["want"]
    res = tp["res"]
    for group in _groups():
        a, b = (res[r]["vq"]["indices"] for r in group)
        np.testing.assert_array_equal(a, b)
    got = np.concatenate([res[g[0]]["vq"]["indices"] for g in _groups()])
    assert got.shape == want["vq_indices"].shape
    num = got.shape[-1]
    z = torch.from_numpy(want["vq_z"].copy()).reshape(-1, num, 16 // num)
    n_diff, n_far = index_differences(torch.from_numpy(got).reshape(-1, num),
                                      torch.from_numpy(want["vq_indices"].copy()).reshape(-1, num), z,
                                      torch.from_numpy(want["vq_codebook"]))
    assert n_far == 0 and n_diff <= 1e-3 * got.size, (n_diff, n_far)


# --------------------------------------------------------------------------
# (e) Checkpoints across layouts
# --------------------------------------------------------------------------

def test_resume_in_the_same_layout_is_bit_equal(tp):
    for r in tp["res"]:
        got = r["resume"]
        assert got["start"] == 1
        for k, v in got["unbroken"].items():
            np.testing.assert_array_equal(got["same_layout"][k], v, err_msg=k)


def test_saved_in_the_world_resumes_in_a_world_of_one(tp):
    run = tp["runs"]["resume"]
    cfg = _vt_cfg(out=run["cfg"].OUTPUT_DIR)
    tr = _si_trainer(cfg, run["si"][1:])
    assert tr.resume_or_load(resume=True) == 1
    _step(tr, run["batches"][1])
    _close(_np_flat(tr.state.params), tp["res"][0]["resume"]["unbroken"], "resumed at M = 1")


def test_saved_by_a_world_of_one_resumes_in_the_world(tp):
    for r in tp["res"]:
        assert r["resume"]["from_one_start"] == 1
        _close(r["resume"]["from_one"], tp["one_unbroken"], f"rank {r['rank']} resumed at M = 2")


# --------------------------------------------------------------------------
# (f) Refusals
# --------------------------------------------------------------------------

def test_the_layouts_the_port_refuses():
    cfg = _vt_cfg()
    cfg.TPU.SHARD_SPATIAL = True  # spatial sharding is accepted: a world of one, no group
    assert tmesh.data_group(cfg) is None and tmesh.layout(cfg, 4) == (4, 1)
    cfg.TPU.SHARD_SPATIAL = False
    cfg.TPU.MESH_MODEL = 2
    with pytest.raises(ValueError, match="MESH_MODEL 2 does not divide the world of 3"):
        tmesh.layout(cfg, 3)
    assert tmesh.layout(cfg, 4) == (2, 2)
    cfg.TPU.MESH_DATA = 4
    with pytest.raises(ValueError, match="MESH_DATA 4"):
        tmesh.layout(cfg, 4)
    # the CLI refuses before it starts a process
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_net_torch
    from lvt_tpu_torch.engine.defaults import default_argument_parser

    args = default_argument_parser().parse_args(
        ["--num-gpus", "3", "--dist-backend", "gloo", "--config-file",
         os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"), "TPU.MESH_MODEL", "2"])
    with pytest.raises(ValueError, match="MESH_MODEL 2 does not divide the world of 3"):
        train_net_torch.run(args, device="cpu")
    # the generation script shards videos, not weights: it refuses a model axis
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch

    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        generate_videos_torch.main(["--config-file", os.path.join(ROOT, "configs", "vt",
                                                                  "DSFVT.yaml"),
                                    "--video-dir", os.path.join(ROOT, "example"),
                                    "TPU.MESH_MODEL", "2"], device="cpu")


# --------------------------------------------------------------------------
# The training CLI
# --------------------------------------------------------------------------

def test_the_cli_trains_and_evaluates_under_tensor_parallelism(tp):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_net_torch
    from lvt_tpu_torch.data.catalog import DatasetCatalog
    from lvt_tpu_torch.engine.defaults import default_argument_parser

    cli = tp["runs"]["cli"]
    res = [r["cli"] for r in tp["res"]]
    assert all(r[s]["step"] == 2 for r in res for s in ("vq", "vt"))
    assert res[0]["vt"]["local"]["netG.decoder.layers.0.wq"] == (1, 32, 16)  # 2 heads split
    assert res[0]["vq"]["state"]["netC.embedding"] == (4, 512 // MODEL, 4)  # K split
    assert all(r["vq_eval"] == {} and r["vt_eval"] == {} for r in res[1:])  # rank 0 reports
    for name, fn in cli["datasets"].items():
        DatasetCatalog._REGISTERED.pop(name, None)
        DatasetCatalog.register(name, fn)
    one = {}
    for stage, argv in cli["argv"].items():
        out = argv[argv.index("OUTPUT_DIR") + 1]
        shutil.copytree(out, out + "_one", ignore=shutil.ignore_patterns("inference"))
        argv = argv[:argv.index("OUTPUT_DIR")] + ["OUTPUT_DIR", out + "_one", "TPU.MESH_MODEL",
                                                  "1"]
        one[stage] = (train_net_torch.main(default_argument_parser().parse_args(
            ["--eval-only"] + argv), device="cpu"), out)
    np.testing.assert_allclose(res[0]["vt_eval"]["likelihood"]["bits_per_dim"],
                               one["vt"][0]["likelihood"]["bits_per_dim"], rtol=1e-6)
    np.testing.assert_allclose(res[0]["vq_eval"]["reconstruction"]["MSE"],
                               one["vq"][0]["reconstruction"]["MSE"], rtol=1e-3)
    roots = [os.path.join(d, "inference", "dp_frames_test")
             for d in (one["vq"][1], one["vq"][1] + "_one")]
    files = sorted(os.listdir(roots[0]))
    assert files == sorted(os.listdir(roots[1])) and len(files) == 2
    got, want = ([np.load(os.path.join(r, v, f)) for v in files
                  for f in sorted(os.listdir(os.path.join(r, v)))] for r in roots)
    n = sum(a.size for a in want)
    assert len(got) == len(want) == 16
    assert sum(int((a != b).sum()) for a, b in zip(got, want)) <= max(1, n // 1000)
