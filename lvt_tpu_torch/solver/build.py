"""Optimizers and LR schedules (counterpart of lvt_tpu/solver/build.py).

* RMSprop and Adam are ``torch.optim.RMSprop`` / ``torch.optim.Adam``:
  lvt_tpu rebuilt exactly their recurrences on optax (eps outside the sqrt,
  torch's momentum order, bias-corrected Adam moments, L2 decay added to the
  gradient), so here they are the originals.
* Weight decay comes in three groups keyed on the parameter's dotted name
  (``checkpoint.convert.flatten``), with lvt_tpu's rules: NORM for the
  LayerNorm leaves and for the "bias" of a {"scale", "bias"} norm dict,
  BIAS for bias-named leaves, BASE for the rest.
* The schedule is a multiplicative factor on the base lr (Identity,
  WarmupMultiStepLR, WarmupCosineLR, constant or linear warmup), applied by
  a ``LambdaLR`` that steps once per optimizer update. Under
  ACCUMULATION_STEPS = A the k-th update reads the factor at iteration
  k * A, so warmups and milestones fire at their configured iterations.
"""

import math
from typing import Callable, Dict, List, Tuple

import torch

_NORM_NAMES = ("ln_scale", "ln_bias", "ffn_ln_scale", "ffn_ln_bias", "scale")
_BIAS_NAMES = ("b", "bias", "ctx_bias", "conv_b", "ln_bias", "ffn_ln_bias",
               "ffn_b1", "ffn_b2", "P_b", "U_b")


def _warmup_factor(method: str, it: int, warmup_iters: int, warmup_factor: float) -> float:
    if warmup_iters <= 0 or it >= warmup_iters:
        return 1.0
    if method == "constant":
        return warmup_factor
    if method == "linear":
        alpha = it / warmup_iters
        return warmup_factor * (1 - alpha) + alpha
    raise ValueError(f"Unknown warmup method: {method}")


def build_lr_schedule(cfg) -> Callable[[int], float]:
    """schedule(iteration) -> multiplicative lr factor (base lr excluded)."""
    S = cfg.SOLVER
    name = S.LR_SCHEDULER_NAME
    if name == "Identity":
        return lambda step: 1.0
    if name not in ("WarmupMultiStepLR", "WarmupCosineLR"):
        raise ValueError(f"Unknown LR scheduler: {name}")
    if S.WARMUP_ITERS > 0 and S.WARMUP_METHOD not in ("constant", "linear"):
        raise ValueError(f"Unknown warmup method: {S.WARMUP_METHOD}")

    def warm(step):
        return _warmup_factor(S.WARMUP_METHOD, step, S.WARMUP_ITERS, S.WARMUP_FACTOR)

    if name == "WarmupMultiStepLR":
        milestones = list(S.STEPS)
        if milestones != sorted(milestones):
            raise ValueError(f"SOLVER.STEPS must be increasing, got {milestones}")
        return lambda step: warm(step) * S.GAMMA ** sum(step >= m for m in milestones)
    return lambda step: warm(step) * 0.5 * (1.0 + math.cos(math.pi * step / S.MAX_ITER))


def decay_group(name: str, names) -> str:
    """"norm", "bias" or "base" for the parameter ``name`` (dotted) among
    all parameter names ``names``."""
    parts = name.split(".")
    if any(p in _NORM_NAMES for p in parts):
        return "norm"
    if parts[-1] == "bias" and len(parts) > 1:
        prefix = ".".join(parts[:-1]) + "."
        siblings = {n[len(prefix):] for n in names if n.startswith(prefix)}
        if siblings == {"scale", "bias"}:
            return "norm"
    trailing = next((p for p in reversed(parts) if not p.isdigit()), "")
    return "bias" if trailing in _BIAS_NAMES else "base"


def build_optimizer(cfg, named_params: Dict[str, torch.Tensor],
                    suffix: str = "_G") -> Tuple[torch.optim.Optimizer,
                                                 torch.optim.lr_scheduler.LambdaLR]:
    """(optimizer, per-update LambdaLR) over ``named_params`` with the
    reference's hyperparameter suffix scheme. Group order: base, bias, norm
    (empty groups left out)."""
    S = cfg.SOLVER
    if S.OPT_STATE_DTYPE not in ("float32", "bfloat16"):
        raise ValueError(f"SOLVER.OPT_STATE_DTYPE must be 'float32' or 'bfloat16', "
                         f"got {S.OPT_STATE_DTYPE!r}")
    lr = getattr(S, "LR" + suffix)
    decay = {g: getattr(S.WEIGHT_DECAY, g.upper() + suffix) for g in ("base", "bias", "norm")}
    members: Dict[str, List[torch.Tensor]] = {"base": [], "bias": [], "norm": []}
    names = list(named_params)
    for n, p in named_params.items():
        members[decay_group(n, names)].append(p)
    groups = [{"params": members[g], "weight_decay": decay[g], "name": g}
              for g in ("base", "bias", "norm") if members[g]]
    if S.OPTIMIZER_NAME == "adam":
        opt = torch.optim.Adam(groups, lr=lr, eps=1e-8, betas=(
            getattr(S.ADAM, "BETA1" + suffix), getattr(S.ADAM, "BETA2" + suffix)))
    elif S.OPTIMIZER_NAME == "rmsprop":
        opt = torch.optim.RMSprop(groups, lr=lr, eps=1e-8,
                                  alpha=getattr(S.RMSPROP, "ALPHA" + suffix),
                                  momentum=getattr(S.RMSPROP, "MOMENTUM" + suffix))
    else:
        raise ValueError(f"Unknown optimizer: {S.OPTIMIZER_NAME}")
    if S.OPT_STATE_DTYPE != "float32":
        cast_opt_state(opt, getattr(torch, S.OPT_STATE_DTYPE))
    schedule = build_lr_schedule(cfg)
    accum = S.ACCUMULATION_STEPS
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda k: schedule(k * accum))


def cast_opt_state(opt: torch.optim.Optimizer, dtype: torch.dtype) -> torch.optim.Optimizer:
    """Store ``opt``'s moments in ``dtype`` between steps while each update is
    computed in fp32, as lvt_tpu's ``cast_opt_state``: a hook before every
    step upcasts the state, one after it rounds the new state back, and one
    after ``load_state_dict`` rounds a loaded state. bf16 halves the memory
    the moments hold between steps, not a step's traffic: the two casts add
    a read and a write of every moment to the fp32 update. Each cast is one
    ``_foreach_copy_`` over all moments. The moments are the floating tensors
    of a parameter's shape; ``step``, a count that torch keeps as a float
    scalar, stays as it is, as optax's integer count does."""
    def cast(to):
        slots = [(st, k) for p, st in opt.state.items() for k, v in st.items()
                 if k != "step" and isinstance(v, torch.Tensor) and v.is_floating_point()
                 and v.shape == p.shape and v.dtype != to]
        if not slots:
            return
        src = [st[k] for st, k in slots]
        dst = [torch.empty_like(v, dtype=to) for v in src]
        torch._foreach_copy_(dst, src)
        for (st, k), v in zip(slots, dst):
            st[k] = v

    opt.register_step_pre_hook(lambda *_: cast(torch.float32))
    opt.register_step_post_hook(lambda *_: cast(dtype))
    opt.register_load_state_dict_post_hook(lambda *_: cast(dtype))
    return opt
