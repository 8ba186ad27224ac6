"""Default CLI plumbing, setup, inference adapters and the DefaultTrainer
(counterpart of lvt_tpu/engine/defaults.py; reference
vidgen/engine/defaults.py:37-363), for VT and VQ-VAE alike: the config's
META_ARCHITECTURE picks the model, DATASETS.TRAIN / DATASETS.TEST the
latent-code or image datasets.

The inference adapters wrap each meta-architecture's passes into the
``infer_fn(batch) -> list[dict]`` protocol of
evaluation.inference_on_dataset, on the device that holds the params. They
have no compile cache to keep (lvt_tpu's ``_cached_jit``): the one costly
set-up, the rollout's CUDA graph of a slice, is kept by the model
(``models/rollout_graph.py`` ``SliceGraphSlot``) across batches and across
EvalHook calls while the weights stand, and captured anew once after an
optimizer step changed them in place.
"""

import argparse
import functools
import logging
import os
from collections import OrderedDict

import numpy as np
import torch
import torch.distributed as dist

from ..config import set_global_cfg
from ..data import build_test_loader, build_train_loader
from ..evaluation import (
    BitsEvaluator,
    CodesExtractor,
    DatasetEvaluator,
    DatasetEvaluators,
    FVDEvaluator,
    MSEEvaluator,
    VTSampler,
    inference_on_dataset,
    print_csv_format,
    verify_results,
)
from ..models import tree_leaves
from ..parallel.mesh import data_rank, model_group, tensor_parallel
from ..utils import comm
from ..utils.collect_env import collect_env_info
from ..utils.env import seed_all_rng
from ..utils.events import CommonMetricPrinter, JSONWriter, TensorboardWriter
from ..utils.logger import setup_logger
from .hooks import EvalHook, IterationTimer, LRSchedulerHook, PeriodicCheckpointer, PeriodicWriter
from .trainer import Trainer

logger = logging.getLogger(__name__)

EVALUATOR_REGISTRY = {
    "MSEEvaluator": MSEEvaluator,
    "BitsEvaluator": BitsEvaluator,
    "CodesExtractor": CodesExtractor,
    "VTSampler": VTSampler,
    "FVDEvaluator": FVDEvaluator,
}


def default_argument_parser():
    """reference defaults.py:37-69: the config, --resume, --eval-only, and the
    world of processes that engine.launch starts, one per GPU."""
    parser = argparse.ArgumentParser(description="lvt_tpu_torch training")
    parser.add_argument("--config-file", default="", metavar="FILE",
                        help="path to config file")
    parser.add_argument("--resume", action="store_true",
                        help="resume from OUTPUT_DIR checkpoints")
    parser.add_argument("--eval-only", action="store_true", help="evaluate only")
    parser.add_argument("--num-gpus", type=int, default=1, help="processes (GPUs) per machine")
    parser.add_argument("--num-machines", type=int, default=1, help="total number of machines")
    parser.add_argument("--machine-rank", type=int, default=0,
                        help="the rank of this machine (unique per machine)")
    parser.add_argument("--dist-url", default="auto",
                        help="tcp://<host>:<port> of machine 0; 'auto' takes a free port on "
                             "this machine (one machine only)")
    parser.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                        help="the process group's backend: NCCL unless gloo is asked for "
                             "(gloo runs on the CPU, or puts several processes on one card)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="config overrides: KEY VALUE pairs")
    return parser


def default_setup(cfg, args):
    """Logging, the environment report (utils/collect_env.py), seeding and
    the config dump (reference defaults.py:72-121). Each process seeds its
    global generators with SEED + its data rank (its rank // TPU.MESH_MODEL,
    ``parallel.mesh.data_rank``), as lvt_tpu does, so that the data workers
    of different data-parallel ranks draw differently and the ranks of a
    model group draw alike."""
    output_dir = cfg.OUTPUT_DIR
    rank = comm.get_rank()
    if output_dir:  # every rank: the others' logs go there too
        os.makedirs(output_dir, exist_ok=True)
    log = setup_logger(output_dir, distributed_rank=rank, name="lvt_tpu_torch")
    log.info(f"Rank of current process: {rank}. World size: {comm.get_world_size()}")
    log.info("Environment info:\n" + collect_env_info())
    if getattr(args, "config_file", ""):
        log.info(f"Loaded config file {args.config_file}")
    if comm.is_main_process() and output_dir:
        path = os.path.join(output_dir, "config.yaml")
        with open(path, "w") as f:
            f.write(cfg.dump())
        log.info(f"Full config saved to {path}")
    seed_all_rng(None if cfg.SEED < 0 else cfg.SEED + data_rank(cfg)[0])
    set_global_cfg(cfg)


def rank_device(device) -> torch.device:
    """``device`` as this process's own: "cuda" becomes cuda:<index> of the
    card that engine.launch gave the process (its local rank; card 0 with
    no launch)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


# --------------------------------------------------------------------------
# Inference adapters
# --------------------------------------------------------------------------

def params_device(params) -> torch.device:
    """The device of a param tree (of its first tensor)."""
    return tree_leaves(params)[0].device


def build_vqvae_infer_fn(cfg, model, params, state):
    """Per-video reconstruction + latent extraction (reference
    AutoEncoderModel.forward mode='inference', ae.py:120-147): frames to the
    device, reconstruct, clip(denormalize, 0, 1 or 255); latents (T, nc, h, w)."""
    clamp_hi = 1.0 if cfg.INPUT.SCALE_TO_ZEROONE else 255.0
    device = params_device(params)

    @torch.no_grad()
    def infer(batch):
        outputs = []
        key = "image_sequence" if "image_sequence" in batch else "image"
        arr = batch[key]
        for i in range(len(arr)):
            frames = torch.as_tensor(np.asarray(arr[i])).to(device)  # (T, H, W, C)
            recon, idx = model.reconstruct(params, state, model.normalize(frames))
            recon = model.denormalize(recon).clamp(0.0, clamp_hi)
            outputs.append({
                "reconstruction": recon.cpu().numpy(),
                # (T, h, w, nc) -> reference layout (T, nc, h, w)
                "latent": idx.permute(0, 3, 1, 2).cpu().numpy(),
            })
        return outputs

    return infer


def build_vt_infer_fn(cfg, model, params, *, gen=None):
    """Whole-video teacher-forced logits and/or sampling, dispatched on
    TEST.EVALUATORS (reference VideoTransformerModel.forward
    mode='inference', vt.py:192-206). ``gen``: the sampler's generator, on
    the params' device; by default one seeded from max(SEED, 0) plus the
    process's data rank (each data-parallel rank samples its own videos),
    which each batch's draws advance."""
    evaluators = cfg.TEST.EVALUATORS
    want_logits = "BitsEvaluator" in evaluators
    want_samples = ("VTSampler" in evaluators) or ("FVDEvaluator" in evaluators)
    n_prime_eval = cfg.MODEL.AUTOREGRESSIVE.VT.N_PRIME
    knobs = cfg.TEST.VT_SAMPLER
    n_prime_sample = knobs.N_PRIME
    num_samples = knobs.NUM_SAMPLES
    device = params_device(params)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(max(cfg.SEED, 0) + data_rank(cfg)[0])

    @torch.no_grad()
    def infer(batch):
        codes = np.asarray(batch["video"])  # (b, nc, T, H, W)
        video = torch.as_tensor(codes).to(device).long()
        cls = torch.as_tensor(np.asarray(batch["class"])).to(device).long() if (
            "class" in batch and model.c.class_num > 0) else None
        b, _, T = video.shape[:3]
        outputs = [{} for _ in range(b)]

        if want_logits:
            # BitsEvaluator reduces on the host in float64, as in lvt_tpu: the
            # fp32 logits of a DSFVT video, 16 x 16 x 16 x 4 x 512, are 32 MiB
            lg = model.logits_for_entire_video(params, video, cls).cpu().numpy()
            ignore_t = np.arange(T) < n_prime_eval
            for i in range(b):
                outputs[i]["logits"] = lg[i]
                outputs[i]["ignore_t"] = ignore_t
        if want_samples:
            # all num_samples rollouts ride the batch axis of ONE sample_video
            # call (the reference loops sample_video num_samples times,
            # vt.py:221-223)
            vrep = video.repeat(num_samples, 1, 1, 1, 1)
            crep = None if cls is None else cls.repeat(num_samples)
            primed = vrep.clone()
            primed[:, :, n_prime_sample:] = 0
            out = model.sample_video(params, primed, gen, n_prime=n_prime_sample,
                                     class_idx=crep, kv_cache_dtype=knobs.KV_DTYPE,
                                     kv_seg_size=knobs.SEG, weight_dtype=knobs.WEIGHT_DTYPE,
                                     attn_impl=knobs.ATTN_IMPL)
            samples = out.reshape((num_samples,) + tuple(video.shape)).cpu().numpy()
            samples = samples.astype(codes.dtype)  # (S, b, ...) in the loader's dtype
            for i in range(b):
                outputs[i]["samples"] = [samples[s, i] for s in range(num_samples)]
        assert all(outputs), "No evaluator-compatible output produced"
        return outputs

    return infer


def build_evaluators(cfg, dataset_name, output_dir, device="cuda"):
    """TEST.EVALUATORS' evaluators; VTSampler and FVDEvaluator decode on
    ``device``."""
    names = [n.strip().strip("'\"") for n in cfg.TEST.EVALUATORS.split(",")
             if n.strip().strip("'\"")]
    evs = []
    for name in names:
        if name not in EVALUATOR_REGISTRY:
            raise KeyError(
                f"Unknown evaluator {name!r}; available: "
                f"{sorted(EVALUATOR_REGISTRY)}")
        cls = EVALUATOR_REGISTRY[name]
        if name in ("VTSampler", "FVDEvaluator"):
            evs.append(cls(cfg, dataset_name, distributed=True, output_dir=output_dir,
                           device=device))
        else:
            evs.append(cls(dataset_name, distributed=True, output_dir=output_dir))
    return DatasetEvaluators(evs)


def run_test(cfg, model, params, state=None):
    """Loop DATASETS.TEST on the device that holds ``params`` (reference
    DefaultTrainer.test, defaults.py:312-363). In a world of several
    processes each evaluates its shard of the test set (InferenceSampler)
    and the evaluators gather to rank 0, which alone returns results (the
    others return {} per dataset). Under tensor parallelism ``params`` and
    ``state`` are the rank's parts, the shards are the data axis's, every
    rank of a model group runs the model on its group's shard, and only the
    group's first rank hands the outputs to the evaluators."""
    from ..models.vqvae import VQVAE, AutoEncoder
    from ..models.vt import VideoTransformer

    tp = model_group(cfg)
    results = OrderedDict()
    for dataset_name in cfg.DATASETS.TEST:
        loader = build_test_loader(cfg, dataset_name)
        out_dir = os.path.join(cfg.OUTPUT_DIR, "inference")
        evaluator = build_evaluators(cfg, dataset_name, out_dir, params_device(params))
        if isinstance(model, (VQVAE, AutoEncoder)):
            infer_fn = build_vqvae_infer_fn(cfg, model, params, state)
        elif isinstance(model, VideoTransformer):
            infer_fn = build_vt_infer_fn(cfg, model, params)
        else:
            raise TypeError(f"Cannot infer with {type(model)}")
        if tp is not None:
            infer_fn = functools.partial(_in_model_group, tp, infer_fn)
            if dist.get_rank(tp) != 0:  # the group's outputs are counted once
                evaluator = _Unfed(evaluator)
        r = inference_on_dataset(infer_fn, loader, evaluator)
        results[dataset_name] = r
        if comm.is_main_process() and r:
            logger.info(f"Evaluation results for {dataset_name}:")
            print_csv_format(r)
    if len(results) == 1:
        results = list(results.values())[0]
    return results


def _in_model_group(group, infer_fn, batch):
    with tensor_parallel(group):
        return infer_fn(batch)


class _Unfed(DatasetEvaluator):
    """An evaluator that takes no outputs but resets and evaluates (gathers)
    with the others."""

    def __init__(self, inner):
        self._inner = inner

    def reset(self):
        self._inner.reset()

    def process(self, inputs, outputs):
        pass

    def evaluate(self):
        return self._inner.evaluate()


# --------------------------------------------------------------------------
# DefaultTrainer
# --------------------------------------------------------------------------

class DefaultTrainer(Trainer):
    """Trainer + default hooks and writers (reference defaults.py:124-310),
    on this process's card (``rank_device``)."""

    def __init__(self, cfg, device="cuda"):
        loader, _ = build_train_loader(cfg)
        super().__init__(cfg, loader, device=rank_device(device))
        self.register_hooks(self.build_hooks())

    def build_writers(self):
        out = self.cfg.OUTPUT_DIR
        writers = [CommonMetricPrinter(self.cfg.SOLVER.MAX_ITER),
                   JSONWriter(os.path.join(out, "metrics.json"))]
        try:
            writers.append(TensorboardWriter(out))
        except ImportError:
            pass
        return writers

    def build_hooks(self):
        from ..solver.build import build_lr_schedule

        cfg = self.cfg
        hooks = [
            IterationTimer(),
            LRSchedulerHook(cfg.SOLVER.LR_G, build_lr_schedule(cfg)),
            PeriodicCheckpointer(cfg.OUTPUT_DIR, cfg.SOLVER.CHECKPOINT_PERIOD),
        ]
        if cfg.TEST.EVAL_PERIOD > 0:
            def eval_fn():
                return run_test(cfg, self.model, self.state.params, self.state.model_state)

            hooks.append(EvalHook(cfg.TEST.EVAL_PERIOD, eval_fn))
        if comm.is_main_process():  # the metrics are the global batch's on every rank
            hooks.append(PeriodicWriter(self.build_writers()))
        return hooks

    def test(self):
        """run_test on the current weights, then verify_results against
        TEST.EXPECTED_RESULTS (exits with 1 on a miss)."""
        results = run_test(self.cfg, self.model, self.state.params, self.state.model_state)
        if comm.is_main_process():
            verify_results(self.cfg, results)
        return results
