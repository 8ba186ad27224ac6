"""The numbers that decide ``correct``, each worked out by the plain
reference (``benchmark/reference``) in float32 from the benchmark's own
weights and inputs, against what the timed path produced; or, for the
controls and faults of ``calibrate.py``, against what the reference in
another precision or with a planted fault produces in the program's place.

Generation (every number 0 where the two agree exactly):

* ``vt_gap``: over every served token of the checked videos (every sampled
  position and channel of every sampled slice), the reference's best score
  less its score of the served token, the reference teacher-forced on the
  served video. The videos are sampled at temperature 1: the program serves
  argmax(softmax(logits) / E), E ~ Exp(1) drawn from the batch's generator,
  one (batch, nv) draw a position and channel, slice by slice
  (``torch.multinomial``'s numbers, as the port documents them). The check
  replays those draws (``sampler_draws``) from a generator seeded alike, and
  a token's score is its logit - log E: where both sides' logits agree the
  served token is the reference's best, and the gap grows with the logits'
  error as a greedy token's would. A control serves, at each position of
  the same videos and under the same draws, the token its own scores put
  first.
* ``code_gap``: over every sub-vector of the checked videos' priming
  latents, the reference's squared distance to the served code less its
  least one, over 2 |z| max |c| (the scale of the term that decides).
* ``frame_err``: the largest difference, in [0, 255] pixel steps, between a
  served frame and the reference's decoding of the served codes.

Training, over the first three steps that set-up drives through the
window's own call (each gap by the worst leaf, against the reference's norm
of that leaf or of the median leaf, whichever is larger):

* ``loss_gap``: |loss - reference loss| / reference loss, worst step;
* ``grad_gap``: the first step's gradient norm of each leaf, the program's
  read from its optimizer's state after step 1;
* ``update_gap``: each leaf's change after three steps, leaves whose
  reference gradient is under a thousandth of the median leaf's left out
  (they move by round-off alone under RMSprop's scaling).
"""

from typing import Dict, List

import numpy as np
import torch

from reference import optim as ropt
from reference import vqvae as rvq
from reference import vt as rvt
from reference.precision import FP32, set_true_fp32

from .traffic import ClipLoader, sampling_generator
from .weights import VQ_WEIGHTS, VT_WEIGHTS, cast, leaves, make_tree, stream_seed

ROWS = 32  # videos the reference takes at a time
SMALL_GRAD = 1e-3  # a leaf's gradient under this share of the median leaf's moves by round-off


def vq_tree(q: Dict, seed: int, device):
    """The VQ-VAE's (params, state) in the port's layout, float32: one dict
    a layer, the EMA codebook's running sums as the port's init sets them."""
    tree = {"params": {"netE": [{} for _ in rvq.encoder_spec(q)],
                       "netG": [{} for _ in rvq.generator_spec(q)], "netC": {}},
            "state": {"netE": [{} for _ in rvq.encoder_spec(q)],
                      "netG": [{} for _ in rvq.generator_spec(q)], "netC": {}}}
    make_tree(rvq.param_specs(q), stream_seed(seed, VQ_WEIGHTS), device, tree)
    cb = tree["state"]["netC"]
    cb["running_size"] = torch.zeros(cb["embedding"].shape[:2], device=cb["embedding"].device)
    cb["running_sum"] = cb["embedding"].clone()
    return tree["params"], tree["state"]


def vt_tree(v: Dict, seed: int, device, dtype=torch.float32):
    """The VT's netG tree, float32 holding the values of ``dtype``."""
    return cast(cast(make_tree(rvt.param_specs(v), stream_seed(seed, VT_WEIGHTS), device),
                     dtype), torch.float32)


@torch.no_grad()
def sampler_draws(v: Dict, shape, n_prime: int, seed: int, batch: int, batches, rows,
                  device) -> torch.Tensor:
    """The Exp(1) draws behind the served videos: video j was row ``rows[j]``
    of window batch ``batches[j]`` (of ``batch`` videos), whose generator
    (``traffic.sampling_generator``) gave, at every sampled slice in order,
    position after position, channel after channel, one (batch, nv) draw.
    Returns (n, sampled slices, positions of a slice, nc, nv) float32."""
    nc, nv = v["NC"], v["NV"]
    slices = rvt.sampled_slices(v, shape, n_prime)
    thw = int(np.prod(rvt.plan_of(v, tuple(shape)).slice_shape))
    out = torch.empty((len(rows), len(slices), thw, nc, nv), device=device)
    buf = torch.empty((nc, batch, nv), device=device)
    batches, rows = torch.as_tensor(batches).cpu(), torch.as_tensor(rows).cpu()
    for i in sorted(set(batches.tolist())):
        mine = torch.nonzero(batches == i).reshape(-1)
        picked = rows[mine].to(device)
        mine = mine.to(device)
        gen = sampling_generator(seed, i, device)
        for j in range(len(slices)):
            for p in range(thw):
                for k in range(nc):
                    buf[k].exponential_(1, generator=gen)
                out[mine, j, p] = buf[:, picked].transpose(0, 1)
    return out


@torch.no_grad()
def vt_gap(v: Dict, params, videos, n_prime: int, draws, control=None) -> float:
    """videos (n, nc, T, H, W): the served videos; draws: their
    ``sampler_draws``; see the module's text."""
    worst = 0.0
    H, W = videos.shape[3:]
    for j, s in enumerate(rvt.sampled_slices(v, videos.shape[2:], n_prime)):
        for r0 in range(0, videos.shape[0], ROWS):
            rows = videos[r0:r0 + ROWS]
            sidx = torch.full((rows.shape[0],), s, dtype=torch.long)
            ctx, sl, src = rvt.prepare_slices(v, rows, sidx)
            lg = rvt.logits(params, v, ctx, sl, sidx)
            noise = -draws[r0:r0 + ROWS, j].double().log().reshape(lg.shape)
            score = lg.double() + noise
            if control is None:
                served = sl.movedim(1, -1).long()
            else:
                served = (rvt.logits(params, v, ctx, sl, sidx, control).double()
                          + noise).argmax(-1)
            at = torch.gather(score, -1, served[..., None])[..., 0]
            gap = torch.where(torch.isposinf(at), 0.0, score.amax(-1) - at)  # a draw of 0
            sampled = (src // (H * W) >= n_prime)[..., None]  # primed positions keep their code
            worst = max(worst, float(torch.where(sampled, gap, 0.0).max()))
    return worst


@torch.no_grad()
def code_gap(q: Dict, params, state, frames, codes, control=None) -> float:
    """frames (n, H, W, 3) in [0, 255]; codes (n, h, w, num) served."""
    worst = 0.0
    emb = state["netC"]["embedding"]
    for r0 in range(0, frames.shape[0], ROWS * 4):
        z = rvq.features(q, params, frames[r0:r0 + ROWS * 4])
        sc = rvq.scores(z.double(), emb.double())  # (N, num, K), exact in float64
        if control is None:
            got = codes[r0:r0 + ROWS * 4].reshape(sc.shape[:2]).long()
        else:
            got = torch.argmin(rvq.scores(z, emb, control), dim=-1)
        gap = torch.gather(sc, -1, got[..., None])[..., 0] - sc.amin(-1)
        zn = z.double().reshape(sc.shape[0], sc.shape[1], -1).norm(dim=-1)
        scale = 2.0 * zn * emb.double().norm(dim=-1).amax(-1)[None]
        worst = max(worst, float((gap / scale.clamp(min=1e-30)).max()))
    return worst


@torch.no_grad()
def frame_err(q: Dict, params, state, codes, frames, control=None) -> float:
    """codes (n, h, w, num) served; frames (n, H, W, 3) served."""
    worst = 0.0
    for r0 in range(0, codes.shape[0], ROWS * 4):
        ref = rvq.decode(q, params, state, codes[r0:r0 + ROWS * 4])
        got = frames[r0:r0 + ROWS * 4].float() if control is None else \
            rvq.decode(q, params, state, codes[r0:r0 + ROWS * 4], control)
        worst = max(worst, float((got - ref).abs().max()))
    return worst


def gen_numbers(config: Dict, seed: int, kept: Dict, batch: int, device, control_vt=None,
                control_vq=None) -> Dict[str, float]:
    """kept: the served rows (frames (n, n_prime, H, W, 3), primed (n, nc,
    n_prime, h, w), codes (n, nc, T, h, w), video (n, T, H, W, 3) on
    ``device``; batch (n,) the window batch of each, row (n,) its row there,
    ``vt`` (n,) bool: the videos whose tokens the VT check takes), of batches
    of ``batch`` videos."""
    set_true_fp32()
    v, q = config["vt"], config["vqvae"]
    n_prime = config["video"]["N_PRIME_TEST"]
    out = {}
    t = kept["vt"]
    codes = kept["codes"][t.to(kept["codes"].device)]
    params = vt_tree(v, seed, device, getattr(torch, config["dtype"]))
    draws = sampler_draws(v, codes.shape[2:], n_prime, seed, batch, kept["batch"][t],
                          kept["row"][t], device)
    out["vt_gap"] = vt_gap(v, params, codes, n_prime, draws, control_vt)
    del params, draws
    qp, qs = vq_tree(q, seed, device)
    n, nc = kept["primed"].shape[:2]
    frames = kept["frames"].reshape((-1,) + kept["frames"].shape[2:])
    primed = kept["primed"].permute(0, 2, 3, 4, 1).reshape((-1,) + kept["primed"].shape[3:] + (nc,))
    out["code_gap"] = code_gap(q, qp, qs, frames, primed, control_vq)
    codes = kept["codes"].permute(0, 2, 3, 4, 1).reshape((-1,) + kept["codes"].shape[3:] + (nc,))
    video = kept["video"].reshape((-1,) + kept["video"].shape[2:])
    out["frame_err"] = frame_err(q, qp, qs, codes, video, control_vq)
    return out


def _gap(got: List[float], ref: List[float], keep=None) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if keep is not None:
        got, ref = got[keep], ref[keep]
    scale = np.maximum(ref, np.median(ref))
    return float(np.max(np.abs(got - ref) / np.maximum(scale, 1e-30)))


def train_reference(config: Dict, traffic: Dict, seed: int, cfg_seed: int, device, steps: int,
                    prec=FP32, fault: str = "") -> Dict[str, List[float]]:
    """The reference's (or, with ``prec`` / ``fault``, a control's or a
    faulty program's) first ``steps`` steps from the benchmark's weights and
    batches: losses, the first step's gradient norm of each leaf, each leaf's
    change norm after the steps. ``fault``: "half_batch" takes the loss over
    the first half of each batch; "token" alters one code of each batch."""
    set_true_fp32()
    v, tr = config["vt"], config["train"]
    s = tr["SOLVER"]
    video = config["video"]
    T, H, W = video["T"], video["H"], video["W"]
    batch = s["IMS_PER_BATCH"]
    w = make_tree(rvt.param_specs(v), stream_seed(seed, VT_WEIGHTS), device)
    start = [x.detach().clone() for x in leaves(w)]
    for x in leaves(w):
        x.requires_grad_(True)
    opt = ropt.RMSprop(leaves(w), s["LR_G"], s["RMSPROP"]["ALPHA_G"], s["RMSPROP"]["MOMENTUM_G"])
    batches = iter(ClipLoader(seed, traffic["pool"], batch, v["NC"], v["NV"], (T, H, W)))
    losses, gnorms = [], None
    for k in range(steps):
        vid = torch.as_tensor(next(batches)["video"]).to(device).long()
        sidx = rvt.train_slice_indices(v, cfg_seed, k, batch, T)
        if fault == "half_batch":
            vid, sidx = vid[:batch // 2], sidx[:batch // 2]
        elif fault == "token":
            vid[0, 0, -1, -1, -1] = (vid[0, 0, -1, -1, -1] + 1) % v["NV"]
        loss = rvt.loss(w, v, vid, sidx, v["N_PRIME"], prec)
        grads = torch.autograd.grad(loss, leaves(w))
        if gnorms is None:
            gnorms = [float(g.double().norm()) for g in grads]
        opt.step(grads)
        losses.append(float(loss.detach()))
        del grads, loss
    moved = [float((x.detach() - x0).double().norm()) for x, x0 in zip(leaves(w), start)]
    return {"loss": losses, "grad": gnorms, "update": moved}


def train_numbers(got: Dict[str, List[float]], ref: Dict[str, List[float]]) -> Dict[str, float]:
    """The three gaps of ``got`` (the program's readings, or a control's)
    against the reference's."""
    grad = np.asarray(ref["grad"])
    keep = grad >= SMALL_GRAD * np.median(grad)
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"]))
    return {"loss_gap": float(loss), "grad_gap": _gap(got["grad"], ref["grad"]),
            "update_gap": _gap(got["update"], ref["update"], keep)}
