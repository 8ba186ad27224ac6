"""The port's data-parallel training held to lvt_tpu's Trainer step over
its data mesh, on the CPU. One world of 2 gloo processes, spawned once for
the module through engine.launch (tests/torch_dp_worker.py), runs every
scenario; lvt_tpu runs beside it in this process on the 8-device CPU mesh of
tests/conftest.py.

* 3 train steps of a global batch of 8, 4 rows a rank, against lvt_tpu's
  make_train_step jitted with the batch placed by
  lvt_tpu.parallel.mesh.shard_batch over 8 devices, from the same weights
  and slice indices: the tiny VT of tests/test_torch_train.py unfused and
  fused (RMSprop), the tiny VQ-VAE of tests/test_torch_vqvae_train.py with
  its EMA codebook and NORM BN, SyncBN, nnSyncBN (Adam, lr 3e-5). The bounds of
  tests/test_torch_train.py: the loss (the flushed, rank-averaged metrics)
  within 2e-6, every param within rtol 1e-4 and atol 2e-5, the EMA codebook
  and the batch norms' running statistics within 1e-5 of each leaf's
  largest value; both ranks' params and model state bit-equal after every
  step.
* ACCUMULATION_STEPS 2, a checkpoint at step 3 (mid-window) and a resume by
  a new trainer end bit-equal to the unbroken run (the port against itself,
  from its own init).
* Seeds: default_setup seeds SEED + rank, so the ranks' generators and the
  loader's replacement draws (with and without workers) differ across
  ranks; a dataset is listed by rank 0 before the others read its path
  cache.
* tools/train_net_torch.py's main as --num-gpus 2 --dist-backend gloo runs
  it in each process: a VQ-VAE and a VT train 2 steps (ranks bit-equal);
  then --eval-only in the same world gives the world-of-one MSE and bits/dim
  (to float64 reduction order: 1e-12) and the same latent files.
* generate_videos_torch.generate_sharded across the 2 ranks: the
  world-of-one greedy codes bit for bit.
"""

import contextlib
import functools
import os
import pickle
import shutil
import sys
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lvt_tpu.config import get_cfg as jax_get_cfg
from lvt_tpu.engine.trainer import TrainState, make_train_step
from lvt_tpu.models import build_model as jax_build_model
from lvt_tpu.models.vt import VideoTransformer as JaxVT
from lvt_tpu.parallel.mesh import build_mesh, replicated, shard_batch
from lvt_tpu.solver.build import build_optimizer as jax_build_optimizer
from lvt_tpu_torch.checkpoint.convert import flatten
from lvt_tpu_torch.config import get_cfg
from lvt_tpu_torch.data.datasets.latents import get_latent_video_paths
from lvt_tpu_torch.engine.trainer import Trainer
from lvt_tpu_torch.models import build_model
from lvt_tpu_torch.models.vt import VideoTransformer
from lvt_tpu_torch.utils.image import get_image_paths, get_video_paths
from test_torch_train import H, T, W, _jax_fused_on_cpu, _to_port
from test_torch_train import _cfg as vt_cfg
from test_torch_train import _solver as vt_solver
from test_torch_vqvae_train import _cfg as vq_cfg
from test_torch_vqvae_train import _leaf_close, _port_trees
from test_torch_vqvae_trainer import _solver as vq_solver
from torch_dp_worker import dp_scenarios, generation_models, one_thread_children, spawn_world

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLOBAL = 8  # global batch: 4 rows on each of 2 ranks, 1 on each of lvt_tpu's 8 devices
STEPS = 3
VQ_NORMS = ("BN", "SyncBN", "nnSyncBN")


# --------------------------------------------------------------------------
# The runs: the same weights and data for the world and for lvt_tpu
# --------------------------------------------------------------------------

def _vt_run(rng, fused, accumulation=1, steps=STEPS):
    solver = dict(vt_solver("rmsprop"), ACCUMULATION_STEPS=accumulation)
    batches = [{"video": rng.integers(0, 8, (GLOBAL, 2, T, H, W)).astype(np.int32)}
               for _ in range(steps)]
    si = [rng.integers(0, 4, (GLOBAL,)).astype(np.int64) for _ in range(steps)]
    return {"cfg": vt_cfg(fused=fused, **solver), "batches": batches, "si": si, "steps": steps,
            "jax_cfg": vt_cfg(jax_get_cfg, fused, **solver), "opt": "rmsprop", "fused": fused}


def _vq_run(norm, batches):
    # a tenth of tests/test_torch_vqvae_trainer.py's Adam lr: at 3e-4 one
    # first-conv weight in 384, whose step-3 gradient is at fp32 noise under
    # the global batch norm (sums over 2 ranks vs 8 devices), took a
    # sign-like Adam step 3.7e-5 away from lvt_tpu's
    solver = dict(vq_solver("adam"), ACCUMULATION_STEPS=1, LR_G=3e-5)
    jcfg, cfg = vq_cfg(jax_get_cfg, True, **solver), vq_cfg(get_cfg, True, **solver)
    for c in (jcfg, cfg):
        for net in (c.MODEL.ENCODER, c.MODEL.GENERATOR):
            net.NORM = norm
    return {"cfg": cfg, "batches": batches, "si": None, "steps": STEPS, "jax_cfg": jcfg,
            "opt": "adam", "fused": False}


def _jax_tree_of_port_init(jm, cfg):
    """lvt_tpu's (params, state) holding the port's init from cfg.SEED (the
    converters of lvt_tpu_torch/checkpoint/convert.py keep every path, so
    each leaf is found by its dotted name); quicker here than lvt_tpu's own
    init, which this only shapes (jax.eval_shape)."""
    model = (VideoTransformer(cfg, T=T, H=H, W=W) if isinstance(jm, JaxVT)
             else build_model(cfg))
    flat = [flatten(t) for t in model.init(torch.Generator().manual_seed(cfg.SEED))]
    out = []
    for tree, port in zip(jax.eval_shape(jm.init, jax.random.key(0)), flat):
        leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
        arrays = []
        for path, leaf in leaves:
            name = ".".join(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", None))))
                            for k in path)
            arrays.append(jnp.asarray(port[name].numpy()))
            assert arrays[-1].shape == leaf.shape and arrays[-1].dtype == leaf.dtype, name
        out.append(jax.tree_util.tree_unflatten(treedef, arrays))
    return out


def _port(run, params, mstate):
    """A JAX params (and model state) tree as the port's trees."""
    if run["si"] is not None:
        return {"netG": _to_port(params["netG"])}, {}
    return _port_trees(params, mstate)


def _port_tree_at(run, trainer, state):
    """lvt_tpu's TrainState as the port's checkpoint tree (the layout of
    tests/test_torch_train.py's _port_tree, with lvt_tpu's update count)."""
    _, inner, sched = state.opt_state
    fields = {"square_avg": inner.v, "momentum_buffer": inner.buf} if run["opt"] == "rmsprop" \
        else {"exp_avg": inner.mu, "exp_avg_sq": inner.nu}
    fields = {k: flatten(_port(run, v, state.model_state)[0]) for k, v in fields.items()}
    st = trainer.state
    names = {id(p): n for n, p in flatten(st.params).items()}
    opt_sd = st.optimizer.state_dict()
    opt_sd["state"] = {}
    for group in st.optimizer.param_groups:
        for p in group["params"]:
            opt_sd["state"][len(opt_sd["state"])] = {
                "step": torch.tensor(float(sched.count)),
                **{k: v[names[id(p)]].clone() for k, v in fields.items()}}
    params, mstate = _port(run, state.params, state.model_state)
    return {"params": params, "model_state": mstate,
            "opt_state": {"optimizer": opt_sd, "scheduler": st.scheduler.state_dict()},
            "step": int(state.step),
            "accum_grads": jax.tree_util.tree_map(torch.zeros_like, params)}


def _jax_trajectory(run):
    """lvt_tpu's make_train_step over the 8-device data mesh from the run's
    init: the port's checkpoint tree of the state before each step (the
    synced scheme of tests/test_torch_train.py), and after each step the
    params and model state (port layout) and the step's total loss."""
    if run["si"] is not None:
        jm = JaxVT(run["jax_cfg"], T=T, H=H, W=W)
        jm.use_pallas = True if run["fused"] else None
    else:
        jm = jax_build_model(run["jax_cfg"])
    jp, js = _jax_tree_of_port_init(jm, run["cfg"])
    opt = jax_build_optimizer(jm.cfg)
    mesh = build_mesh(data=8, model=1)
    if run["si"] is not None:  # the slice indices ride the batch, sharded with it
        def train_loss(p, mstate, batch, rng):
            loss, metrics = JaxVT.loss(jm, p, {"video": batch["video"]}, rng,
                                       slice_idx=batch["si"])
            return loss, (metrics, mstate)

        jm.train_loss = train_loss
    state = jax.device_put(TrainState(jp, js, opt.init(jp), None, jnp.zeros((), jnp.int32)),
                           replicated(mesh))
    step = jax.jit(make_train_step(jm, opt, 1))
    trainer = Trainer(run["cfg"], iter(()), device="cpu")  # the optimizer's layout and lr
    trees, want = [], []
    with _jax_fused_on_cpu() if run["fused"] else contextlib.nullcontext():
        for i, b in enumerate(run["batches"]):
            trees.append(_port_tree_at(run, trainer, state))
            batch = dict(b) if run["si"] is None else dict(b, si=run["si"][i].astype(np.int32))
            state, metrics = step(state, shard_batch(mesh, batch), jax.random.key(0))
            with warnings.catch_warnings():  # stepped without the optimizer, on purpose
                warnings.simplefilter("ignore", UserWarning)
                trainer.state.scheduler.step()  # the next update's lr, as the port's run sets it
            params, mstate = (flatten(t) for t in _port(run, state.params, state.model_state))
            want.append({"params": params, "model_state": mstate,
                         "loss": float(sum(float(v) for v in metrics.values()))})
    return trees, want


def _write_cli_data(root, rng):
    """PNG frames (4 train videos x 4 frames, 2 test videos x 8 frames, 32 x
    32) and latent videos (6 x 8 frames of (4, 8, 8) codes < 512)."""
    for split, n_videos, n_frames in (("train", 4, 4), ("test", 2, 8)):
        for v in range(n_videos):
            d = os.path.join(root, "frames", split, f"video_{v}")
            os.makedirs(d)
            for f in range(n_frames):
                Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(
                    os.path.join(d, f"{f}.png"))
    for v in range(6):
        d = os.path.join(root, "latents", f"video_{v}")
        os.makedirs(d)
        for f in range(8):
            np.save(os.path.join(d, f"{f}.npy"), rng.integers(0, 512, (4, 8, 8)))


def _cli_payload(root):
    m, vt = "MODEL.", "MODEL.AUTOREGRESSIVE.VT."
    vq = ["--config-file", os.path.join(ROOT, "configs", "vqvae", "PR-DVQVAE2.yaml"),
          m + "ENCODER.NF", "16", m + "ENCODER.RES_CHANNELS", "8", m + "ENCODER.N_LAYERS", "1",
          m + "GENERATOR.NF", "16", m + "GENERATOR.RES_CHANNELS", "8",
          m + "GENERATOR.N_LAYERS", "1", m + "GENERATOR.IN_CHANNELS", "16",
          m + "CODEBOOK.DIM", "16", "TPU.COMPUTE_DTYPE", "float32",
          "INPUT.N_FRAMES_PER_VIDEO_TEST", "8", "SOLVER.IMS_PER_BATCH", "4",
          "SOLVER.CHECKPOINT_PERIOD", "2", "DATASETS.TRAIN", "('dp_frames',)",
          "DATASETS.TEST", "('dp_frames_test',)", "TEST.EVALUATORS",
          "MSEEvaluator,CodesExtractor", "DATALOADER.NUM_WORKERS", "0",
          "OUTPUT_DIR", os.path.join(root, "vq_out")]
    vtv = ["--config-file", os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"),
           vt + "D", "32", vt + "DA", "16", vt + "DE", "16", vt + "STRIDE", "(8,1,1)",
           vt + "BLOCKS_E", "((1,8,8),(1,8,8))", vt + "N_HEAD_E", "(2,2)",
           vt + "BLOCKS_D", "((1,8,8),(1,8,8))", vt + "N_HEAD_D", "(2,2)",
           vt + "N_PRIME", "1", "TPU.FUSED_LAYER", "False", "TPU.COMPUTE_DTYPE", "float32",
           "INPUT.N_FRAMES_PER_VIDEO_TRAIN", "8", "INPUT.N_FRAMES_PER_VIDEO_TEST", "8",
           "SOLVER.IMS_PER_BATCH", "4", "SOLVER.CHECKPOINT_PERIOD", "2",
           "DATASETS.TRAIN", "('dp_latents',)", "DATASETS.TEST", "('dp_latents',)",
           "TEST.EVALUATORS", "BitsEvaluator", "DATALOADER.NUM_WORKERS", "0",
           "OUTPUT_DIR", os.path.join(root, "vt_out")]
    frames, latents = os.path.join(root, "frames"), os.path.join(root, "latents")
    return {"argv": {"vq": vq, "vt": vtv}, "datasets": {
        "dp_frames": functools.partial(get_image_paths, os.path.join(frames, "train"),
                                       use_cache=False),
        "dp_frames_test": functools.partial(get_video_paths, os.path.join(frames, "test"),
                                            use_cache=False),
        "dp_latents": functools.partial(get_latent_video_paths, latents, use_cache=False)}}


def _generate_payload(rng):
    """tests/test_torch_pipeline.py's narrow PR-DVQVAE2 and DSFVT, 4 videos
    of 3 priming frames (2 a rank)."""
    vq, vt = get_cfg(), get_cfg()
    vq.merge_from_file(os.path.join(ROOT, "configs", "vqvae", "PR-DVQVAE2.yaml"))
    vq.MODEL.ENCODER.NF = vq.MODEL.GENERATOR.NF = 32
    vq.MODEL.ENCODER.RES_CHANNELS = vq.MODEL.GENERATOR.RES_CHANNELS = 16
    vq.MODEL.CODEBOOK.DIM = vq.MODEL.GENERATOR.IN_CHANNELS = 32
    vq.MODEL.CODEBOOK.SIZE = 16
    vt.merge_from_file(os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"))
    v = vt.MODEL.AUTOREGRESSIVE.VT
    v.NV, v.D, v.DA, v.DE = 16, 32, 16, 16
    v.STRIDE, v.KERNEL = (8, 1, 1), (3, 1, 1)
    v.BLOCKS_E = v.BLOCKS_D = ((1, 4, 4),) * 2
    v.N_HEAD_E = v.N_HEAD_D = (2, 2)
    frames = (rng.random((4, 3, 16, 16, 3)) * 255).astype(np.float32)
    return {"vq_cfg": vq, "vt_cfg": vt, "T": 8, "n_prime": 3, "frames": frames}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dp"))
    rng = np.random.default_rng(0)
    runs = {"vt": _vt_run(rng, False), "vt_fused": _vt_run(rng, True)}
    frames = [{"image": rng.uniform(0.0, 1.0, (GLOBAL, 16, 16, 3)).astype(np.float32)}
              for _ in range(STEPS)]
    for norm in VQ_NORMS:
        runs[f"vq_{norm}"] = _vq_run(norm, frames)
    resume = _vt_run(rng, False, accumulation=2, steps=5)
    resume["cfg"].OUTPUT_DIR = os.path.join(tmp, "resume")
    setup_cfg = get_cfg()
    setup_cfg.SEED, setup_cfg.OUTPUT_DIR = 5, os.path.join(tmp, "setup")
    _write_cli_data(tmp, rng)
    listing = os.path.join(tmp, "listing")
    os.makedirs(os.path.join(listing, "video_0"))
    np.save(os.path.join(listing, "video_0", "0.npy"), np.zeros((2, 2, 2), np.int64))
    trees_dir = os.path.join(tmp, "trees")
    os.makedirs(trees_dir)
    payload = {"setup_cfg": setup_cfg, "listing_root": listing, "cli": _cli_payload(tmp),
               "generate": _generate_payload(rng),
               "resume": _plain(resume), "trees_dir": trees_dir,
               "runs": {k: _plain(r) for k, r in runs.items()}}

    # the world runs while lvt_tpu computes its trajectories here: each run's
    # trees reach the ranks through a file, written whole (None: lvt_tpu failed)
    world = {}

    def spawn():
        try:
            world["res"] = spawn_world(dp_scenarios, payload, os.path.join(tmp, "ranks"))
        except BaseException as e:  # raised again below, in the test's thread
            world["err"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    want, written = {}, set()
    try:
        # the VQ-VAE's three batch norms are one computation to lvt_tpu's step
        # over its mesh: one trajectory holds all three
        for name in ("vt", "vt_fused", "vq_BN"):
            want[name] = _jax_trajectory(runs[name])
            for k in ([name] if name != "vq_BN" else [f"vq_{n}" for n in VQ_NORMS]):
                _write_trees(trees_dir, k, want[name][0])
                written.add(k)
    finally:
        for k in set(runs) - written:
            _write_trees(trees_dir, k, None)
        thread.join()
    if "err" in world:
        raise world["err"]
    want = {k: want["vq_BN" if k.startswith("vq_") else k][1] for k in runs}
    return {"tmp": tmp, "runs": runs, "want": want, "res": world["res"], "cli": payload["cli"],
            "generate": payload["generate"]}


def _write_trees(trees_dir, name, trees):
    tmp = os.path.join(trees_dir, name + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(trees, f)
    os.replace(tmp, os.path.join(trees_dir, name + ".pkl"))


def _plain(run):
    """The run as the ranks take it: no JAX objects."""
    return {k: v for k, v in run.items() if k not in ("jax_cfg", "opt")}


# --------------------------------------------------------------------------
# Train steps against lvt_tpu over its data mesh
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["vt", "vt_fused"] + [f"vq_{n}" for n in VQ_NORMS])
def test_train_steps_match_lvt_tpu_over_its_data_mesh(dp, name):
    res = [r[name] for r in dp["res"]]
    want = dp["want"][name]
    for r in res:  # the flushed metrics: the global batch's, on every rank
        losses = [sum(vals) for vals in zip(*r["metrics"].values())]
        assert len(losses) == STEPS
        for i, w in enumerate(want):
            np.testing.assert_allclose(losses[i], w["loss"], rtol=2e-6, err_msg=f"loss {i}")
    for i, w in enumerate(want):
        got = res[0]["states"][i]
        for other in res[1:]:
            for part in ("params", "model_state"):
                for k, v in got[part].items():
                    np.testing.assert_array_equal(other["states"][i][part][k], v,
                                                  err_msg=f"step {i} ranks differ: {k}")
        assert set(got["params"]) == set(w["params"])
        for k, v in w["params"].items():
            np.testing.assert_allclose(got["params"][k], v.numpy(), rtol=1e-4, atol=2e-5,
                                       err_msg=f"step {i} param {k}")
        assert set(got["model_state"]) == set(w["model_state"])
        for k, v in w["model_state"].items():
            _leaf_close(f"step {i} state {k}", got["model_state"][k], v.numpy(), 1e-5)


def test_the_vqvae_runs_cover_the_ema_codebook_and_each_batch_norm(dp):
    for norm in VQ_NORMS:
        states = dp["want"][f"vq_{norm}"][-1]["model_state"]
        assert {"netC.running_size", "netC.running_sum"} <= set(states)
        assert any(k.endswith(".var") for k in states), sorted(states)
        assert dp["runs"][f"vq_{norm}"]["cfg"].MODEL.ENCODER.NORM == norm


def test_resume_mid_window_continues_the_unbroken_run(dp):
    for r in dp["res"]:
        got = r["resume"]
        assert got["start"] == 3
        for part in ("params", "accum"):
            for k, v in got["full"][part].items():
                np.testing.assert_array_equal(got["resumed"][part][k], v, err_msg=f"{part} {k}")
    a, b = (r["resume"]["full"]["params"] for r in dp["res"])
    assert all(np.array_equal(a[k], b[k]) for k in a)


# --------------------------------------------------------------------------
# Seeds and data
# --------------------------------------------------------------------------

def test_default_setup_seeds_seed_plus_rank(dp):
    """Fails where every rank seeds SEED alone."""
    a, b = (r["seeds"] for r in dp["res"])
    assert a[1] == 5 and b[1] == 6
    assert a[0] != b[0] and a[2] != b[2]


@pytest.mark.parametrize("workers", [0, 2])
def test_replacement_draws_differ_across_ranks(dp, workers):
    a, b = (r["draws"][workers] for r in dp["res"])
    assert len(a) == len(b) == 8 and all(v % 8 == 0 for v in a + b)
    assert a != b


def test_rank_0_lists_a_dataset_before_the_others(dp):
    (seen0, n0), (seen1, n1) = (r["listing"] for r in dp["res"])
    assert seen0 == [False] and seen1 == [True] and n0 == n1 == 1


# --------------------------------------------------------------------------
# The training CLI in the world, and --eval-only against a world of one
# --------------------------------------------------------------------------

def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def world_of_one(dp):
    """Both --eval-only runs in this process on copies of the world's
    OUTPUT_DIRs (their latest checkpoints, step 2)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_net_torch
    from lvt_tpu_torch.data.catalog import DatasetCatalog
    from lvt_tpu_torch.engine.defaults import default_argument_parser

    for name, fn in dp["cli"]["datasets"].items():
        DatasetCatalog._REGISTERED.pop(name, None)
        DatasetCatalog.register(name, fn)
    out = {}
    for stage, argv in dp["cli"]["argv"].items():
        world_dir = argv[argv.index("OUTPUT_DIR") + 1]
        one_dir = world_dir + "_one"
        shutil.copytree(world_dir, one_dir, ignore=shutil.ignore_patterns("inference"))
        argv = argv[:argv.index("OUTPUT_DIR")] + ["OUTPUT_DIR", one_dir]
        out[stage] = (train_net_torch.main(default_argument_parser().parse_args(
            ["--eval-only"] + argv), device="cpu"), world_dir, one_dir)
    return out


def test_cli_trains_two_steps_in_the_world(dp):
    for stage in ("vq", "vt"):
        a, b = (r["cli"][stage] for r in dp["res"])
        assert a["step"] == b["step"] == 2
        assert all(np.array_equal(a["params"][k], b["params"][k]) for k in a["params"])
        out = dp["cli"]["argv"][stage][dp["cli"]["argv"][stage].index("OUTPUT_DIR") + 1]
        assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["ckpt_2.pt"]
        assert os.path.exists(os.path.join(out, "metrics.json"))
        assert os.path.exists(os.path.join(out, "log.txt.rank1"))


def test_eval_only_in_the_world_equals_a_world_of_one(dp, world_of_one):
    res = [r["cli"] for r in dp["res"]]
    assert res[1]["vq_eval"] == {} and res[1]["vt_eval"] == {}  # rank 0 alone reports
    mse, one = res[0]["vq_eval"]["reconstruction"]["MSE"], world_of_one["vq"][0]
    assert np.isfinite(mse)
    np.testing.assert_allclose(mse, one["reconstruction"]["MSE"], rtol=1e-12)
    bits = res[0]["vt_eval"]["likelihood"]["bits_per_dim"]
    assert np.isfinite(bits)
    np.testing.assert_allclose(bits, world_of_one["vt"][0]["likelihood"]["bits_per_dim"],
                               rtol=1e-12)
    _, world_dir, one_dir = world_of_one["vq"]
    roots = [os.path.join(d, "inference", "dp_frames_test") for d in (world_dir, one_dir)]
    files = _files(roots[0])
    assert files == _files(roots[1]) and len(files) == 2 * 8
    for f in files:
        np.testing.assert_array_equal(np.load(os.path.join(roots[0], f)),
                                      np.load(os.path.join(roots[1], f)), err_msg=f)


# --------------------------------------------------------------------------
# Sharded generation
# --------------------------------------------------------------------------

def test_sharded_generation_equals_a_world_of_one(dp):
    """generate_sharded over 2 ranks (2 videos each) against generate() over
    all 4 in this process: greedy codes and primed codes bit for bit, the
    decoded frames within fp32 noise."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt

    gen = dp["generate"]
    want = gvt.generate(*generation_models(gen), torch.from_numpy(gen["frames"]),
                        gen["n_prime"], None, greedy=True)
    got = dp["res"][0]["generate"]
    assert dp["res"][1]["generate"] is None  # rank 0 alone gathers
    assert got[1].shape == (4, 4, 8, 4, 4)
    np.testing.assert_array_equal(got[1], want[1].numpy())
    np.testing.assert_array_equal(got[2], want[2].numpy())
    np.testing.assert_allclose(got[0], want[0].numpy(), atol=255 * 1e-5, rtol=0)


def test_the_cli_launches_its_world_and_verifies_on_rank_0(dp, world_of_one, monkeypatch):
    """tools/train_net_torch.py's run(): --num-gpus 2 --dist-backend gloo
    spawns the world itself (engine.launch), whose processes read the test
    latents at their builtin.py path (prdvqvae_test, under the working
    directory); --eval-only there meets TEST.EXPECTED_RESULTS set to the
    world of one's bits/dim within 1e-9 (rank 0 exits with 1 on a miss,
    which makes run() raise)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_net_torch
    from lvt_tpu_torch.engine.defaults import default_argument_parser

    cwd = os.path.join(dp["tmp"], "cli_cwd")
    os.makedirs(os.path.join(cwd, "datasets", "prdvqvae2", "inference"))
    os.symlink(os.path.join(dp["tmp"], "latents"),
               os.path.join(cwd, "datasets", "prdvqvae2", "inference", "bair_test_seq"))
    monkeypatch.chdir(cwd)
    bits = float(world_of_one["vt"][0]["likelihood"]["bits_per_dim"])
    argv = dp["cli"]["argv"]["vt"]
    argv = argv[:argv.index("OUTPUT_DIR")] + ["OUTPUT_DIR", world_of_one["vt"][2]]
    args = default_argument_parser().parse_args(
        ["--num-gpus", "2", "--dist-backend", "gloo", "--eval-only"] + argv +
        ["DATASETS.TEST", "('prdvqvae_test',)",
         "TEST.EXPECTED_RESULTS", f"[['likelihood', 'bits_per_dim', {bits!r}, 1e-9]]"])
    with one_thread_children():
        assert train_net_torch.run(args, device="cpu") is None
