"""The ranks' side of the port's data-parallel CPU tests
(tests/test_torch_comm.py, tests/test_torch_data_parallel.py).

``spawn_world`` runs one scenario function in a world of gloo processes on
the CPU through the port's ``engine.launch``; each rank saves what it
computed, and the test process reads it back and holds it to ``lvt_tpu``.
This module imports torch and the port only: the ranks never import JAX.
"""

import contextlib
import copy
import os
import pickle
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# seconds a whole world may run before its ranks are killed and the test fails
JOIN_TIMEOUT = 300


@contextlib.contextmanager
def one_thread_children():
    """Processes started inside begin with one OpenMP thread
    (``OMP_NUM_THREADS=1`` in the environment they inherit): the test
    workers already share the cores."""
    before = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        if before is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = before


def spawn_world(fn, payload, out_dir, world=2, join_timeout=JOIN_TIMEOUT):
    """Run ``fn(payload)`` on every rank of a gloo world of ``world`` CPU
    processes; returns the ranks' return values, in rank order."""
    import datetime

    from lvt_tpu_torch.engine.launch import launch

    os.makedirs(out_dir, exist_ok=True)
    # as bytes: torch.multiprocessing would hand every rank one shared-memory
    # storage of each tensor in the payload, and an optimizer state loaded
    # from it would be stepped by every rank at once
    with one_thread_children():
        launch(_run_rank, world, backend="gloo", args=(fn, pickle.dumps(payload), out_dir),
               timeout=datetime.timedelta(seconds=join_timeout), join_timeout=join_timeout)
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _run_rank(fn, payload, out_dir):
    from lvt_tpu_torch.utils import comm

    torch.set_num_threads(1)
    result = fn(pickle.loads(payload))
    with open(os.path.join(out_dir, f"rank{comm.get_rank()}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _np(t):
    return t.detach().cpu().numpy().copy() if isinstance(t, torch.Tensor) else t


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [np_tree(v) for v in tree]
    return _np(tree)


# --------------------------------------------------------------------------
# tests/test_torch_comm.py
# --------------------------------------------------------------------------

def comm_scenarios(payload):
    """utils/comm.py, the three collectives with their gradients, and
    apply_norm(group=) for every synced batch norm, on payload's numpy
    inputs (index [rank] is this rank's part)."""
    import torch.distributed as dist

    from lvt_tpu_torch.models.norms import apply_norm
    from lvt_tpu_torch.parallel import collectives
    from lvt_tpu_torch.utils import comm

    r = comm.get_rank()
    res = {"world": (comm.get_world_size(), r, comm.get_local_rank(), comm.get_local_size(),
                     comm.is_main_process())}
    res["all_gather"] = comm.all_gather({"rank": r, "items": list(range(3 * r + 1)),
                                         "arr": np.arange(r + 2)})
    res["gather"] = comm.gather([r] * (r + 2))
    np.random.seed(100 + r)  # the ranks' own draws differ
    res["own_draw"] = int(np.random.randint(2 ** 31))
    np.random.seed(100 + r)
    res["shared_seed"] = comm.shared_random_seed()
    res["reduce_mean"] = {k: _np(v) for k, v in comm.reduce_dict(
        {"b": float(2 * r), "a": torch.tensor(r + 1.0)}).items()}
    res["reduce_sum"] = comm.reduce_dict({"a": torch.tensor(r + 1.0)}, average=False)
    comm.synchronize()

    for name in ("all_gather", "reduce_scatter", "all_reduce"):
        x = torch.tensor(payload[name]["x"][r], requires_grad=True)
        y = getattr(collectives, name)(x)
        (y * torch.from_numpy(payload[name]["w"][r])).sum().backward()
        res[name + "_fn"] = (_np(y), _np(x.grad))

    p = payload["norm"]
    for norm in ("BN", "SyncBN", "nnSyncBN"):
        x = torch.tensor(p["x"][r], requires_grad=True)
        params = {k: torch.tensor(v, requires_grad=True) for k, v in p["params"].items()}
        state = {k: torch.from_numpy(v) for k, v in p["state"].items()}
        y, ns = apply_norm(norm, params, state, x, True, group=dist.group.WORLD)
        (y * torch.from_numpy(p["w"][r])).sum().backward()
        res[norm] = {"y": _np(y), "state": np_tree(ns), "dx": _np(x.grad),
                     "dparams": {k: _np(v.grad) for k, v in params.items()}}
    return res


def failing_rank(payload):
    """Rank 1 raises while rank 0 waits for it in a barrier."""
    from lvt_tpu_torch.utils import comm

    if comm.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    comm.synchronize()


def hanging_rank(payload):
    """Rank 1 never reaches the barrier."""
    import time

    from lvt_tpu_torch.utils import comm

    if comm.get_rank() == 1:
        time.sleep(600)
    comm.synchronize()


# --------------------------------------------------------------------------
# tests/test_torch_data_parallel.py
# --------------------------------------------------------------------------

def rows(batch, rank, world=2):
    """This rank's consecutive rows of a global batch dict."""
    n = len(next(iter(batch.values()))) // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def dp_scenarios(payload):
    """Every data-parallel scenario of tests/test_torch_data_parallel.py, in
    one world: the seeds, the loader's replacement draws, the dataset
    listing order, the train runs, a resume mid-window, the training CLI."""
    res = {"seeds": _seeds(payload["setup_cfg"]),
           "draws": {w: _replacement_draws(w) for w in (0, 2)},
           "listing": _listing_order(payload["listing_root"])}
    res["resume"] = _resume(payload["resume"])
    res["cli"] = _cli(payload["cli"])
    res["generate"] = _generate(payload["generate"])
    for name, run in payload["runs"].items():
        res[name] = _train_run(dict(run, trees=_wait_for_trees(payload["trees_dir"], name)))
    return res


def _wait_for_trees(trees_dir, name, timeout=JOIN_TIMEOUT):
    """The run's trees, once the test process has written them."""
    import time

    path = os.path.join(trees_dir, name + ".pkl")
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no trees for {name} after {timeout} s")
        time.sleep(0.2)
    with open(path, "rb") as f:
        trees = pickle.load(f)
    if trees is None:
        raise RuntimeError(f"the test process computed no trees for {name}")
    return trees


def _seeds(cfg):
    import random

    from lvt_tpu_torch.engine.defaults import default_setup

    default_setup(cfg, None)
    return (int(np.random.randint(2 ** 31)), int(torch.initial_seed()), random.random())


class _RefusingMapper:
    """Refuses every index but multiples of 8, whose replacement the
    dataset draws."""

    def __call__(self, d):
        return None if d["i"] % 8 else {"video": np.array([d["i"]])}


def _replacement_draws(workers):
    from lvt_tpu_torch.data.build import _MappedDataset, collate

    ds = _MappedDataset([{"i": i} for i in range(256)], _RefusingMapper())
    loader = torch.utils.data.DataLoader(ds, batch_size=4, sampler=list(range(1, 9)),
                                         num_workers=workers, collate_fn=collate)
    return [int(v) for b in loader for v in b["video"].reshape(-1)]


def _listing_order(root):
    """Whether the path cache of a dataset's root existed when this rank
    listed the dataset (rank 0 lists it a second late)."""
    import time

    from lvt_tpu_torch.data.build import get_dataset_dicts
    from lvt_tpu_torch.data.catalog import DatasetCatalog
    from lvt_tpu_torch.data.datasets.latents import get_latent_video_paths
    from lvt_tpu_torch.utils import comm

    seen = []

    def listing():
        if comm.is_main_process():
            time.sleep(1.0)
        seen.append(os.path.exists(os.path.join(root, "latent_video_paths.npy")))
        return get_latent_video_paths(root)

    DatasetCatalog._REGISTERED.pop("dp_listing", None)
    DatasetCatalog.register("dp_listing", listing)
    n = len(get_dataset_dicts(["dp_listing"]))
    return seen, n


def _trainer(run, batches, device="cpu"):
    from lvt_tpu_torch.engine.trainer import Trainer
    from lvt_tpu_torch.utils import comm

    local = [rows(b, comm.get_rank()) for b in batches]
    tr = Trainer(run["cfg"], iter(local), device=device)
    if run.get("si") is not None:
        draws = iter(run["si"])

        def fixed(gen, b, T=None):
            si = next(draws)
            assert b == len(si), (b, len(si))  # drawn for the global batch
            return torch.from_numpy(si)

        tr.model.sample_train_slice_idx = fixed
    return tr


def _state(tr):
    from lvt_tpu_torch.checkpoint.convert import flatten

    return {"params": {k: _np(v) for k, v in flatten(tr.state.params).items()},
            "model_state": {k: _np(v) for k, v in flatten(tr.state.model_state).items()},
            "accum": {k: _np(v) for k, v in flatten(tr.state.accum_grads()).items()}}


def _train_run(run):
    """``run["steps"]`` steps on this rank's rows of ``run["batches"]``,
    each from ``run["trees"][i]`` (lvt_tpu's state before step i, the
    synced scheme): the state after every step and the flushed (global)
    metrics."""
    from lvt_tpu_torch.engine.hooks import CallbackHook

    tr = _trainer(run, run["batches"])
    states = []
    # a copy: the optimizer keeps the loaded state's tensors and steps them in place
    tr.register_hooks([CallbackHook(before_step=lambda t: t.load_tree(
        copy.deepcopy(run["trees"][t.iter])),
                                    after_step=lambda t: states.append(_state(t)))])
    tr.train(0, run["steps"])
    metrics = {k: [v for v, _ in h.values()] for k, h in tr.storage.histories().items()
               if k.startswith("loss")}
    return {"states": states, "metrics": metrics}


def _resume(run):
    """An unbroken run of 5 steps from the trainer's own init, and one broken
    at 3 (mid-window of ACCUMULATION_STEPS 2), saved and resumed by a new
    trainer."""
    from lvt_tpu_torch.checkpoint import save_checkpoint

    full = _trainer(run, run["batches"])
    full.train(0, 3)
    save_checkpoint(run["cfg"].OUTPUT_DIR, 3, full.checkpoint_tree())
    full.train(3, 5)
    resumed = _trainer(dict(run, si=None if run.get("si") is None else run["si"][3:]),
                       run["batches"][3:])
    start = resumed.resume_or_load(resume=True)
    resumed.train(start, 5)
    return {"start": start, "full": _state(full), "resumed": _state(resumed)}


def _cli(cli):
    """tools/train_net_torch.py's main in this world, as --num-gpus 2
    --dist-backend gloo runs it in each process: a VQ-VAE and a VT each
    train 2 steps, then --eval-only of both (rank 0 returns the results)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_net_torch
    from lvt_tpu_torch.data.catalog import DatasetCatalog
    from lvt_tpu_torch.engine.defaults import default_argument_parser

    for name, fn in cli["datasets"].items():
        DatasetCatalog._REGISTERED.pop(name, None)
        DatasetCatalog.register(name, fn)
    parse = default_argument_parser().parse_args
    out = {}
    for stage, argv in cli["argv"].items():
        world = ["--num-gpus", "2", "--dist-backend", "gloo"]
        tr = train_net_torch.main(parse(world + argv + ["SOLVER.MAX_ITER", "2"]), device="cpu")
        out[stage] = {"step": tr.state.step, "params": _state(tr)["params"]}
        out[stage + "_eval"] = train_net_torch.main(parse(world + ["--eval-only"] + argv),
                                                    device="cpu")
    return out


def generation_models(gen):
    """The tiny VQ-VAE and VT of ``gen`` with weights from its seeds:
    (vqvae, vq_params, vq_state, vt, vt_params)."""
    from lvt_tpu_torch.models.vqvae import VQVAE
    from lvt_tpu_torch.models.vt import VideoTransformer

    vq = VQVAE(gen["vq_cfg"])
    vq_params, vq_state = vq.init(torch.Generator().manual_seed(1))
    vt = VideoTransformer(gen["vt_cfg"], T=gen["T"], H=4, W=4)
    vt_params, _ = vt.init(torch.Generator().manual_seed(2))
    return vq, vq_params, vq_state, vt, vt_params


def _generate(gen):
    """scripts/generate_videos_torch.generate_sharded, greedy: each rank
    rolls out its rows; rank 0 gets them all."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt

    out = gvt.generate_sharded(*generation_models(gen), torch.from_numpy(gen["frames"]),
                               gen["n_prime"], None, greedy=True)
    return None if out is None else np_tree(list(out[:3]))
