"""The ranks' side of the port's spatial-parallel CPU tests
(tests/test_torch_sp.py): one world of 4 gloo processes, data 2 x model 2
(TPU.MESH_MODEL 2), runs every scenario; each rank returns what it computed
and the test process holds it to ``lvt_tpu`` and to the whole tensors. This
module imports torch and the port only: the ranks never import JAX.
"""

import copy

import numpy as np
import torch

from torch_dp_worker import _np
from torch_tp_worker import _data_rows, _local, _steps, _trainer, _whole


def sp_scenarios(payload):
    """Every spatial-parallel scenario of tests/test_torch_sp.py, in one
    world: the ops on bands of rows, VQ-VAE steps with rows split, batches
    the key leaves whole, the training CLI, the refusals."""
    from lvt_tpu_torch.utils import comm

    res = {"rank": comm.get_rank()}
    res["ops"] = _ops(payload["ops"])
    for name, run in payload["vq"].items():
        res[name] = _vq(run)
    res["whole"] = _whole_batches(payload["whole"])
    res["refusals"] = _refusals(payload["refusals"])
    res["cli"] = _cli(payload["cli"])
    return res


# --------------------------------------------------------------------------
# (a) The ops on bands of rows against the whole tensors
# --------------------------------------------------------------------------

def _band(x, group):
    """This rank's rows of whole frames x (b, H, W, C)."""
    from lvt_tpu_torch.parallel.spatial import split_rows

    return split_rows(x, group)


def _op(case):
    """fn(x, w) of one op case: the layer of ``apply_seq`` or the norm, with
    its weight (None for the stateless ones)."""
    from lvt_tpu_torch.models.layers2d import apply_seq
    from lvt_tpu_torch.models.norms import apply_norm
    from lvt_tpu_torch.ops.conv import conv2d, conv_transpose2d

    kind = case["kind"]
    if kind == "conv":
        return lambda x, w: conv2d(x, w, None, stride=case["stride"], padding=case["pad"])
    if kind == "convT":
        return lambda x, w: conv_transpose2d(x, w, None, stride=case["stride"],
                                             padding=case["pad"])
    if kind == "norm":
        norm = case["norm"]

        def fn(x, w):  # (y, the new running statistics)
            params = {} if w is None else {"scale": w[0], "bias": w[1]}
            state = {"mean": torch.zeros(x.shape[-1]), "var": torch.ones(x.shape[-1])}
            return apply_norm(norm, params, state, x, True)
        return fn
    layer = case["layer"]
    return lambda x, w: apply_seq([layer], [{}], [{}], x, norm="")[0]


def _ops(run):
    """Each case of run["cases"] on this rank's band inside
    ``spatial_parallel(model group)`` and on the whole tensor: (forward,
    input gradient, weight gradient) of each, this rank's band of the whole
    one's beside its own, and the weight gradient summed over the model
    group beside the whole one's; the running statistics of a batch norm
    too."""
    import torch.distributed as dist

    from lvt_tpu_torch.parallel.mesh import model_group, spatial_parallel

    cfg = run["cfg"]
    group = model_group(cfg)
    out = {}
    for case in run["cases"]:
        fn = _op(case)
        x = torch.from_numpy(case["x"][dist.get_rank() // 2])
        w = None if case["w"] is None else torch.from_numpy(case["w"])
        g_out = torch.from_numpy(case["g"][dist.get_rank() // 2])

        def run_once(x_in, g, rows):
            xv = x_in.clone().requires_grad_(True)
            wv = None if w is None else w.clone().requires_grad_(True)
            with spatial_parallel(rows):
                y = fn(xv, wv)
            state = None
            if isinstance(y, tuple):
                y, state = y
            (y * g).sum().backward()
            return y.detach(), xv.grad, None if wv is None else wv.grad, state

        y_w, dx_w, dw_w, st_w = run_once(x, g_out, None)
        y_b, dx_b, dw_b, st_b = run_once(_band(x, group), _band(g_out, group), group)
        if dw_b is not None:
            dw_b = dw_b.clone()
            dist.all_reduce(dw_b, group=group)
        out[case["name"]] = {
            "y": (_np(y_b), _np(_band(y_w, group))),
            "dx": (_np(dx_b), _np(_band(dx_w, group))),
            "dw": None if dw_b is None else (_np(dw_b), _np(dw_w)),
            "state": None if st_w is None else {k: (_np(st_b[k]), _np(st_w[k])) for k in st_w}}
    from lvt_tpu_torch.parallel.spatial import gather_rows

    x = torch.from_numpy(run["cases"][0]["x"][dist.get_rank() // 2])
    out["gather_rows"] = (_np(gather_rows(_band(x, group), group)), _np(x))
    return out


# --------------------------------------------------------------------------
# (b), (c), (d) VQ-VAE steps with the rows split
# --------------------------------------------------------------------------

def _vq(run):
    """run["batches"] steps of a VQ-VAE trainer with TPU.SHARD_SPATIAL on
    this rank's rows and band: each step's metrics, the halo exchanges it
    made, the rows of z each step quantized on this rank, the indices of step
    1 from the training path and from ``encode`` (under the same context),
    the whole params and model state after the last step, the rank's
    parts."""
    from lvt_tpu_torch.ops import vq
    from lvt_tpu_torch.parallel.mesh import spatial_parallel, tensor_parallel
    from lvt_tpu_torch.parallel.spatial import CALLS

    cfg = run["cfg"]
    tr = _trainer(cfg, run["batches"])
    x = tr._put_batch(_data_rows(run["batches"][0], cfg))["image"]
    with torch.no_grad(), tensor_parallel(tr.model_group), spatial_parallel(tr.model_group):
        enc = tr.model.encode(tr.state.params, tr.state.model_state, tr.model.normalize(x))
    inner, taken = vq.quantize_st, []

    def recording(z_e, codebook, *a, **k):
        res = inner(z_e, codebook, *a, **k)
        taken.append((tuple(z_e.shape), _np(res[2])))
        return res
    vq.quantize_st = recording
    halos, metrics = [], []
    try:
        for b in run["batches"]:
            before = dict(CALLS)
            metrics += _steps(tr, cfg, [b])
            halos.append({k: CALLS[k] - before.get(k, 0) for k in ("forward", "backward")})
    finally:
        vq.quantize_st = inner
    whole, state = _whole(tr)
    _, local_state = _local(tr)
    return {"metrics": metrics, "halos": halos, "z_shapes": [s for s, _ in taken],
            "step_indices": taken[0][1], "encode_indices": _np(enc), "band": tuple(x.shape),
            "params": whole, "state": state, "local_state": local_state}


def _whole_batches(run):
    """Batches the key leaves whole: one step of each trainer with
    TPU.SHARD_SPATIAL True and one with it False, on the same rows and
    slice draws; both trainers' whole params and model state after it."""
    out = {}
    for name, r in run.items():
        got = []
        for shard in (True, False):
            cfg = r["cfg"].clone()
            cfg.defrost()
            cfg.TPU.SHARD_SPATIAL = shard
            tr = _trainer(cfg, r["batches"], copy.deepcopy(r["si"]))
            _steps(tr, cfg, r["batches"])
            got.append(_whole(tr))
        out[name] = got
    return out


def _refusals(run):
    """A height a band cannot take: each (class name, message)."""
    from lvt_tpu_torch.engine.trainer import Trainer

    out = {}
    for name, image in run["images"].items():
        tr = Trainer(run["cfg"], iter(()), device="cpu")
        try:
            tr.train_step(tr._put_batch(_data_rows({"image": image}, run["cfg"])))
            out[name] = None
        except ValueError as e:  # the test asserts the message
            out[name] = ("ValueError", str(e))
    return out


def _cli(cli):
    """tools/train_net_torch.py's main in this world, as --num-gpus 4 runs it
    in each process with TPU.MESH_MODEL 2 TPU.SHARD_SPATIAL True: the
    narrow VQ-VAE trains 2 steps and saves, then --eval-only evaluates the
    checkpoint; each rank returns its step, its parts' shapes and the
    evaluation (rank 0 reports)."""
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
    tr = train_net_torch.main(parse(world + cli["argv"] + ["SOLVER.MAX_ITER", "2"]),
                              device="cpu")
    return {"step": tr.state.step, "rows": tr._spatial is not None,
            "state": {k: tuple(v.shape) for k, v in flatten(tr.state.model_state).items()},
            "eval": train_net_torch.main(parse(world + ["--eval-only"] + cli["argv"]),
                                         device="cpu")}


def op_cases(rng, data=2):
    """The op cases of (a): inputs for each data index (``x``, ``g``), one
    weight; fp32, 8 rows a band at a model axis of 2."""
    cases = []

    def add(name, kind, x_shape, w_shape=None, **kw):
        x = rng.standard_normal((data,) + x_shape).astype(np.float32)
        w = None if w_shape is None else rng.standard_normal(w_shape).astype(np.float32)
        cases.append(dict(name=name, kind=kind, x=x, w=w, **kw))
    for k, s, p in ((3, 1, 1), (4, 2, 1), (1, 1, 0)):
        add(f"conv k{k} s{s} p{p}", "conv", (2, 16, 12, 6), (k, k, 6, 5), stride=s, pad=p)
    add("conv_transpose k4 s2 p1", "convT", (2, 16, 12, 6), (4, 4, 5, 6), stride=2, pad=1)
    add("avgpool 2", "layer", (2, 16, 12, 6), layer=("avgpool", 2))
    add("upsample 2", "layer", (2, 16, 12, 6), layer=("upsample", 2))
    add("pixelshuffle 2", "layer", (2, 16, 12, 8), layer=("pixelshuffle", 2))
    from lvt_tpu_torch.models.norms import VALID_NORMS

    for norm in VALID_NORMS:
        affine = norm not in ("", "IN", "StdN", "StdNV2")
        add(f"norm {norm or 'none'}", "norm", (2, 16, 12, 8), (2, 8) if affine else None,
            norm=norm)
    for c in cases:  # the output's gradient, in the output's shape
        c["g"] = rng.standard_normal(_out_shape(c)).astype(np.float32)
    return cases


def _out_shape(case):
    data, b, h, w, c = case["x"].shape
    kind = case["kind"]
    if kind == "conv":
        s = case["stride"]
        return (data, b, h // s, w // s, case["w"].shape[-1])
    if kind == "convT":
        return (data, b, 2 * h, 2 * w, case["w"].shape[2])
    if kind == "layer":
        layer = case["layer"]
        f = layer[1]
        if layer[0] == "avgpool":
            return (data, b, h // f, w // f, c)
        if layer[0] == "upsample":
            return (data, b, h * f, w * f, c)
        return (data, b, h * f, w * f, c // (f * f))
    return case["x"].shape
