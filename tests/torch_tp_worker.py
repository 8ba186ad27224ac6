"""The ranks' side of the port's tensor-parallel CPU tests
(tests/test_torch_tp.py): one world of 4 gloo processes, data 2 x model 2
(TPU.MESH_MODEL 2), runs every scenario; each rank returns what it computed
and the test process holds it to ``lvt_tpu``. This module imports torch and
the port only: the ranks never import JAX.
"""

import torch

from torch_dp_worker import _np, rows


def _data_rows(batch, cfg):
    """This rank's rows of a global batch dict: its data index's part."""
    from lvt_tpu_torch.parallel.mesh import data_rank

    r, world = data_rank(cfg)
    return rows(batch, r, world)


def _trainer(cfg, batches, si=None):
    """A Trainer on this rank's rows of ``batches``; the slice indices of
    the global batches ``si`` in place of its draws."""
    from lvt_tpu_torch.engine.trainer import Trainer

    tr = Trainer(cfg, iter([_data_rows(b, cfg) for b in batches]), device="cpu")
    if si is not None:
        draws = iter(si)

        def fixed(gen, b, T=None):
            s = next(draws)
            assert b == len(s), (b, len(s))  # drawn for the global batch
            return torch.from_numpy(s)

        tr.model.sample_train_slice_idx = fixed
    return tr


def _steps(tr, cfg, batches):
    """One train step a batch on this rank's rows; each step's metrics."""
    out = []
    for b in batches:
        m = tr.train_step(tr._put_batch(_data_rows(b, cfg)))
        out.append({k: float(v) for k, v in m.items()})
    return out


def _whole(tr):
    """The trainer's params and model state made whole over the model group
    (numpy, by dotted name), as its checkpoints hold them."""
    from lvt_tpu_torch.checkpoint.convert import flatten

    tree = tr.checkpoint_tree()
    return ({k: _np(v) for k, v in flatten(tree["params"]).items()},
            {k: _np(v) for k, v in flatten(tree["model_state"]).items()})


def _local(tr):
    from lvt_tpu_torch.checkpoint.convert import flatten

    return ({k: _np(v) for k, v in flatten(tr.state.params).items()},
            {k: _np(v) for k, v in flatten(tr.state.model_state).items()})


def tp_scenarios(payload):
    """Every tensor-parallel scenario of tests/test_torch_tp.py, in one
    world: VT training, the greedy rollout, a VQ-VAE step with the codebook
    split, checkpoints across layouts, the refusals."""
    from lvt_tpu_torch.utils import comm

    res = {"rank": comm.get_rank()}
    for name, fn in (("train", _train), ("sample", _sample), ("vq", _vq),
                     ("resume", _resume), ("refusals", _refusals), ("cli", _cli)):
        res[name] = fn(payload[name])
    return res


def _train(run):
    """run["steps"] fp32 RMSprop steps of the tiny VT: each step's loss, the
    rank's parts and the whole params after the last."""
    cfg = run["cfg"]
    tr = _trainer(cfg, run["batches"], run["si"])
    metrics = _steps(tr, cfg, run["batches"])
    local, _ = _local(tr)
    whole, _ = _whole(tr)
    return {"losses": [m["loss_cross_entropy"] for m in metrics], "local": local,
            "whole": whole}


def _sample(s):
    """Greedy sample_video of the tiny VT on this data index's rows, with
    the rank's parts of the whole init."""
    from lvt_tpu_torch.models.vt import VideoTransformer
    from lvt_tpu_torch.parallel import sharding
    from lvt_tpu_torch.parallel.mesh import data_rank, model_group, tensor_parallel

    cfg = s["cfg"]
    vt = VideoTransformer(cfg, T=4, H=4, W=4)
    params, _ = vt.init(torch.Generator().manual_seed(cfg.SEED))
    group = model_group(cfg)
    rank, size = sharding.group_rank(group)
    part = sharding.shard_tree(params, rank, size)
    video = torch.from_numpy(_data_rows({"v": s["video"]}, cfg)["v"])
    gen = torch.Generator().manual_seed(data_rank(cfg)[0])
    with tensor_parallel(group):
        codes = vt.sample_video(part, video, gen, n_prime=1, greedy=True)
    return {"codes": _np(codes), "wq": tuple(part["netG"]["decoder"]["layers"][0]["wq"].shape)}


def _vq(v):
    """One VQ-VAE step with the codebook split over K: the indices of this
    rank's frames before it (under the model group), its metrics, the whole
    params and model state after it, the rank's codebook part."""
    from lvt_tpu_torch.parallel.mesh import tensor_parallel

    cfg = v["cfg"]
    tr = _trainer(cfg, v["batches"])
    x = torch.from_numpy(_data_rows(v["batches"][0], cfg)["image"])
    with torch.no_grad(), tensor_parallel(tr.model_group):
        idx = tr.model.encode(tr.state.params, tr.state.model_state, tr.model.normalize(x))
    metrics = _steps(tr, cfg, v["batches"])
    whole, state = _whole(tr)
    _, local_state = _local(tr)
    return {"indices": _np(idx), "metrics": metrics, "params": whole, "state": state,
            "local_state": local_state}


def _resume(r):
    """Checkpoints across layouts. (1) This layout saves after step 1 and
    steps on (the unbroken run); a new trainer in the same layout resumes
    from that file and takes the same step. (2) A file a world of one saved
    (``r["one_dir"]``) resumes here and takes the next step."""
    from lvt_tpu_torch.checkpoint import save_checkpoint

    cfg, batches, si = r["cfg"], r["batches"], r["si"]
    full = _trainer(cfg, batches, si)
    _steps(full, cfg, batches[:1])
    save_checkpoint(cfg.OUTPUT_DIR, 1, full.checkpoint_tree())
    _steps(full, cfg, batches[1:2])
    out = {"unbroken": _whole(full)[0]}
    again = _trainer(cfg, batches[1:], si[1:])
    out["start"] = again.resume_or_load(resume=True)
    _steps(again, cfg, batches[1:2])
    out["same_layout"] = _whole(again)[0]
    one = cfg.clone()
    one.defrost()
    one.OUTPUT_DIR = r["one_dir"]
    from_one = _trainer(one, batches[1:], si[1:])
    out["from_one_start"] = from_one.resume_or_load(resume=True)
    _steps(from_one, one, batches[1:2])
    out["from_one"] = _whole(from_one)[0]
    return out


def _refusals(f):
    """The int8 sampler knobs under the model group: each raises
    NotImplementedError naming ROADMAP.md's item."""
    from lvt_tpu_torch.models.vt import VideoTransformer
    from lvt_tpu_torch.parallel import sharding
    from lvt_tpu_torch.parallel.mesh import model_group, tensor_parallel

    cfg = f["cfg"]
    vt = VideoTransformer(cfg, T=4, H=4, W=4)
    params, _ = vt.init(torch.Generator().manual_seed(0))
    group = model_group(cfg)
    part = sharding.shard_tree(params, *sharding.group_rank(group))
    video = torch.zeros((2, cfg.MODEL.AUTOREGRESSIVE.VT.NC, 4, 4, 4), dtype=torch.int64)
    out = {}
    for knobs in f["knobs"]:
        try:
            with tensor_parallel(group):
                vt.sample_video(part, video, None, n_prime=1, greedy=True, **knobs)
            out[str(knobs)] = None
        except Exception as e:  # the test asserts the class and the message
            out[str(knobs)] = (type(e).__name__, str(e))
    return out


def _cli(cli):
    """tools/train_net_torch.py's main in this world, as --num-gpus 4 runs it
    in each process with TPU.MESH_MODEL 2: a VQ-VAE and a VT train 2 steps,
    then --eval-only of both (rank 0 returns the results)."""
    import os
    import sys

    from torch_dp_worker import ROOT

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_net_torch
    from lvt_tpu_torch.checkpoint.convert import flatten
    from lvt_tpu_torch.data.catalog import DatasetCatalog
    from lvt_tpu_torch.engine.defaults import default_argument_parser

    for name, fn in cli["datasets"].items():
        DatasetCatalog._REGISTERED.pop(name, None)
        DatasetCatalog.register(name, fn)
    parse = default_argument_parser().parse_args
    world = ["--num-gpus", "4", "--dist-backend", "gloo"]
    out = {}
    for stage, argv in cli["argv"].items():
        tr = train_net_torch.main(parse(world + argv + ["SOLVER.MAX_ITER", "2"]), device="cpu")
        out[stage] = {"step": tr.state.step, **{
            part: {k: tuple(v.shape) for k, v in flatten(tree).items()}
            for part, tree in (("local", tr.state.params), ("state", tr.state.model_state))}}
        out[stage + "_eval"] = train_net_torch.main(parse(world + ["--eval-only"] + argv),
                                                    device="cpu")
    return out
