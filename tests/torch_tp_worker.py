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
    split, checkpoints across layouts, the CLI."""
    from lvt_tpu_torch.utils import comm

    res = {"rank": comm.get_rank()}
    for name, fn in (("train", _train), ("sample", _sample), ("vq", _vq),
                     ("resume", _resume), ("cli", _cli)):
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


def _sample_model(cfg):
    """The tiny VT of the sampling scenarios, its whole init, the model
    group and the rank's parts."""
    from lvt_tpu_torch.models.vt import VideoTransformer
    from lvt_tpu_torch.parallel import sharding
    from lvt_tpu_torch.parallel.mesh import model_group

    vt = VideoTransformer(cfg, T=4, H=4, W=4)
    params, _ = vt.init(torch.Generator().manual_seed(cfg.SEED))
    group = model_group(cfg)
    return vt, params, group, sharding.shard_tree(params, *sharding.group_rank(group))


def _sample(s, **knobs):
    """Greedy sample_video of the tiny VT on this data index's rows, with
    the rank's parts of the whole init, in the sampler mode ``knobs``."""
    from lvt_tpu_torch.parallel.mesh import data_rank, tensor_parallel

    cfg = s["cfg"]
    vt, _, group, part = _sample_model(cfg)
    video = torch.from_numpy(_data_rows({"v": s["video"]}, cfg)["v"])
    gen = torch.Generator().manual_seed(data_rank(cfg)[0])
    with tensor_parallel(group):
        codes = vt.sample_video(part, video, gen, n_prime=1, greedy=True, **knobs)
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


# --------------------------------------------------------------------------
# tests/test_torch_tp_sampler.py
# --------------------------------------------------------------------------

def tp_sampler_scenarios(payload):
    """The sampler's modes under the model group (tests/test_torch_tp_sampler.py):
    greedy codes in each mode of ``payload["modes"]``, the teacher-forced
    logits of the video in each kv_cache_dtype of ``payload["teacher"]`` and
    of one slice in each weight mode of ``payload["teacher_slice"]``, each
    with the nearest x.5 that the rank rounded, and the rank's int8
    weights."""
    from lvt_tpu_torch.utils import comm

    s = payload["sample"]
    res = {"rank": comm.get_rank(), "modes": {}}
    for name, knobs in payload["modes"].items():
        res["modes"][name] = _sample(s, **knobs)["codes"]
    res["teacher"] = {kv: _teacher(s, kv) for kv in payload["teacher"]}
    res["teacher_slice"] = {name: _teacher_slice(s, knobs)
                            for name, knobs in payload["teacher_slice"].items()}
    res["weights"] = _int8_weights(s)
    res["split_product"] = _split_product(s)
    res["row_products"] = _row_products(s)
    return res


class _TieMargin:
    """While active: the least distance to x.5 of any value the port rounds
    to an integer (the cache rows, q, the weight rows of kernel 3's plain
    version), in ``margin``; the weights' quantization is left out, where
    both packages round the same numbers (tests/test_torch_sampler_int8.py)."""

    def __enter__(self):
        import lvt_tpu_torch.models.vt_incremental as tvti

        self.margin, self.on = float("inf"), True
        self._inner = inner_round, inner_cols = torch.round, tvti.quantize_cols

        def recording_round(x, *args, **kwargs):
            if self.on:
                frac = x.detach().float()
                self.margin = min(self.margin, float((frac - frac.floor() - 0.5).abs().min()))
            return inner_round(x, *args, **kwargs)

        def quiet_cols(*args, **kwargs):
            self.on = False
            try:
                return inner_cols(*args, **kwargs)
            finally:
                self.on = True

        torch.round, tvti.quantize_cols = recording_round, quiet_cols
        return self

    def __exit__(self, *exc):
        import lvt_tpu_torch.models.vt_incremental as tvti

        torch.round, tvti.quantize_cols = self._inner


def _teacher(s, kv):
    """logits_for_entire_video_incremental of this data index's rows under
    the model group with the cache in ``kv``, and the tie margin."""
    from lvt_tpu_torch.parallel.mesh import tensor_parallel

    cfg = s["cfg"]
    vt, _, group, part = _sample_model(cfg)
    video = torch.from_numpy(_data_rows({"v": s["video"]}, cfg)["v"])
    with _TieMargin() as ties, tensor_parallel(group):
        logits = vt.logits_for_entire_video_incremental(part, video, kv_cache_dtype=kv)
    return {"logits": _np(logits), "margin": ties.margin}


def _teacher_slice(s, knobs):
    """The teacher-forced logits of the middle slice of this data index's
    rows (``sample_slice_incremental``) under the model group in the mode
    ``knobs``, and the tie margin."""
    import numpy as np

    from lvt_tpu_torch.models.vt import vt_encode
    from lvt_tpu_torch.models.vt_incremental import sample_slice_incremental
    from lvt_tpu_torch.parallel.mesh import tensor_parallel

    cfg = s["cfg"]
    vt, _, group, part = _sample_model(cfg)
    video = torch.from_numpy(_data_rows({"v": s["video"]}, cfg)["v"])
    sidx = torch.full((video.shape[0],), vt.plan.num_slices // 2, dtype=torch.int64)
    primed = np.ones(vt.plan.slice_src[0].size, bool)
    with _TieMargin() as ties, tensor_parallel(group), torch.no_grad():
        ctx, sl, _ = vt.prepare_slices(video, sidx)
        zl = vt_encode(part["netG"], vt.c, ctx, sidx)
        _, logits = sample_slice_incremental(part["netG"], vt.c, vt.plan.slice_shape, zl, sl,
                                             None, primed, 1.0, teacher_logits=True, **knobs)
    return {"logits": _np(logits), "margin": ties.margin}


def _int8_weights(s):
    """Each decoder layer's int8 weights and scales as a SliceDecoder with
    int8 weights makes them on this rank: proj and FFN 2 (its rows, the
    group's column scales) and FFN 1 (its columns)."""
    from lvt_tpu_torch.models.vt_incremental import SliceDecoder
    from lvt_tpu_torch.parallel.mesh import tensor_parallel

    cfg = s["cfg"]
    vt, _, group, part = _sample_model(cfg)
    with tensor_parallel(group):
        dec = SliceDecoder(part["netG"], vt.c, vt.plan.slice_shape, 2, "cpu", weight_dtype="int8")
    return [{k: tuple(_np(t) for t in lw[k]) for k in ("proj", "ffn1", "ffn2")}
            for lw in dec.weights]


def _split_product(s):
    """Kernel 11's plain version over a product split by its input rows over
    the model group (ops/quant.py matmul_i8w_split, the rank's half of each
    row and of the weight's rows, the group's column scales) and over the
    whole rows in this process, fp32 and bf16, b 8, K 64, N 24."""
    from lvt_tpu_torch.ops.quant import matmul_i8w, matmul_i8w_split, quantize_cols
    from lvt_tpu_torch.parallel import sharding
    from lvt_tpu_torch.parallel.mesh import model_group

    group = model_group(s["cfg"])
    rank, size = sharding.group_rank(group)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator().manual_seed(31)
        y = torch.randn((8, 64), generator=g).to(dtype)
        w = torch.randn((64, 24), generator=g).to(dtype)
        rows = slice(rank * 64 // size, (rank + 1) * 64 // size)
        wi, sw = quantize_cols(w[rows], dtype, group)
        got = matmul_i8w_split(y[:, rows], wi.t().contiguous(), sw, group, dtype)
        wi, sw = quantize_cols(w, dtype)
        out[str(dtype)] = (_np(got.float()), _np(matmul_i8w(y, wi.t().contiguous(), sw,
                                                            dtype).float()))
    return out


def _row_products(s):
    """SliceDecoder's row-split product (``_mm_rows``) in bf16 with native
    and int8 weights on the rank's half of the rows (int8: the rank's rows
    quantized with the group's column scales), and in this process the whole
    product summed in fp32 and rounded once to bf16 (int8: then scaled),
    b 8, K 64, N 24."""
    import types

    from lvt_tpu_torch.models.vt_incremental import SliceDecoder
    from lvt_tpu_torch.ops.quant import quantize_cols
    from lvt_tpu_torch.parallel import sharding
    from lvt_tpu_torch.parallel.mesh import model_group

    group = model_group(s["cfg"])
    rank, size = sharding.group_rank(group)
    bf16 = torch.bfloat16
    g = torch.Generator().manual_seed(37)
    y = torch.randn((8, 64), generator=g).to(bf16)
    w = torch.randn((64, 24), generator=g).to(bf16)
    rows = slice(rank * 64 // size, (rank + 1) * 64 // size)
    out = {}
    for mode in ("native", "int8"):
        if mode == "native":
            part, want = w[rows], (y.float() @ w.float()).to(bf16)
        else:
            part = quantize_cols(w[rows], bf16, group)
            wi, sw = quantize_cols(w, bf16)
            want = (y.float() @ wi.float()).to(bf16) * sw
        dec = types.SimpleNamespace(weight_dtype=mode, cdtype=bf16)
        got = SliceDecoder._mm_rows(dec, y[:, rows], part, group)
        out[mode] = (_np(got.float()), _np(want.float()))
    return out


def rendezvous_rollout(payload):
    """The native greedy rollout of ``_sample`` in a world started as two
    machines; with the ranks of this rank's machine and of its model group."""
    import torch.distributed as dist

    from lvt_tpu_torch.parallel.mesh import model_group
    from lvt_tpu_torch.utils import comm

    out = _sample(payload)
    out["machine"] = [dist.get_global_rank(comm._LOCAL_PROCESS_GROUP, r)
                      for r in range(comm.get_local_size())]
    group = model_group(payload["cfg"])
    out["model_group"] = [dist.get_global_rank(group, r) for r in range(dist.get_world_size(group))]
    return out
