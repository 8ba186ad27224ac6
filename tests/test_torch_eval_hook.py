"""Evaluation inside and around training in the port, on the CPU (the
counterparts of tests/test_eval_hook.py and tools/train_net.py --eval-only):

* EvalHook during a Trainer run: period 3 over 7 iterations evaluates after
  iterations 3 and 6 and at the end, each result in the storage under eval/;
* a DefaultTrainer with TEST.EVAL_PERIOD > 0 (the training CLI) adds the
  hook: a VT run of 4 steps at period 2 evaluates bits/dim twice into the
  storage, and metrics.json holds the last eval/likelihood/bits_per_dim;
* DefaultTrainer.test checks TEST.EXPECTED_RESULTS: passes within the
  tolerance, exits with 1 outside it;
* tools/train_net_torch.py --eval-only with device="cpu" on both stages:
  PR-DVQVAE2 (narrowed) after 2 training steps, MSE and the latents of every
  test video, then DSFVT (narrowed) over those latents with BitsEvaluator,
  VTSampler and FVDEvaluator and the paired VQ-VAE read from the stage-1
  OUTPUT_DIR;
* a configured weight path that does not exist raises FileNotFoundError.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import lvt_tpu_torch.engine.defaults as defaults
from lvt_tpu_torch.config import get_cfg
from lvt_tpu_torch.data.build import build_train_loader
from lvt_tpu_torch.data.catalog import DatasetCatalog
from lvt_tpu_torch.data.datasets.latents import get_latent_video_paths
from lvt_tpu_torch.engine import EvalHook, Trainer
from lvt_tpu_torch.engine.defaults import DefaultTrainer, default_argument_parser, run_test
from lvt_tpu_torch.utils.image import get_video_paths
from test_torch_evaluation import make_video_tree, vq_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import train_net_torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

VQ_OPTS = ["MODEL.ENCODER.NF", "16", "MODEL.ENCODER.RES_CHANNELS", "8",
           "MODEL.ENCODER.N_LAYERS", "1", "MODEL.GENERATOR.NF", "16",
           "MODEL.GENERATOR.RES_CHANNELS", "8", "MODEL.GENERATOR.N_LAYERS", "1",
           "MODEL.GENERATOR.IN_CHANNELS", "16", "MODEL.CODEBOOK.SIZE", "16",
           "MODEL.CODEBOOK.DIM", "16", "INPUT.N_FRAMES_PER_VIDEO_TRAIN", "2",
           "INPUT.N_FRAMES_PER_VIDEO_TEST", "8", "SOLVER.IMS_PER_BATCH", "4",
           "DATALOADER.NUM_WORKERS", "0"]
VT = "MODEL.AUTOREGRESSIVE.VT."
VT_OPTS = [VT + "NC", "4", VT + "NV", "16", VT + "KERNEL", "(3,1,1)", VT + "STRIDE", "(8,1,1)",
           VT + "D", "32", VT + "DA", "16", VT + "DE", "16", VT + "BLOCKS_E", "((1,8,8),)",
           VT + "N_HEAD_E", "(2,)", VT + "BLOCKS_D", "((1,8,8),)", VT + "N_HEAD_D", "(2,)",
           "TPU.FUSED_LAYER", "False", "INPUT.N_FRAMES_PER_VIDEO_TRAIN", "8",
           "INPUT.N_FRAMES_PER_VIDEO_TEST", "8", "SOLVER.IMS_PER_BATCH", "2",
           "TEST.VT_SAMPLER.N_PRIME", "2", "TEST.VT_SAMPLER.NUM_SAMPLES", "2",
           "DATALOADER.NUM_WORKERS", "0"]
NO_VQ_WEIGHTS = ["TEST.VT_SAMPLER.VQ_VAE.ENCODER_WEIGHTS", "",
                 "TEST.VT_SAMPLER.VQ_VAE.GENERATOR_WEIGHTS", "",
                 "TEST.VT_SAMPLER.VQ_VAE.CODEBOOK_WEIGHTS", ""]


def _register(name, fn):
    DatasetCatalog._REGISTERED.pop(name, None)
    DatasetCatalog.register(name, fn)


def _videos(tmp_path, name="hook_videos"):
    root = str(tmp_path / "vids")
    make_video_tree(root)  # 2 videos x 8 frames of 32x32
    _register(name, lambda: get_video_paths(root, use_cache=False))
    return name


def _latents(tmp_path, name="hook_latents", n=2):
    root = str(tmp_path / "lat")
    rng = np.random.default_rng(0)
    for v in range(n):
        d = os.path.join(root, f"video_{v}")
        os.makedirs(d)
        for t in range(8):
            np.save(os.path.join(d, f"{t}.npy"), rng.integers(0, 16, (4, 8, 8)).astype(np.int64))
    _register(name, lambda: get_latent_video_paths(root, use_cache=False))
    return name


def _main(cfg_file, opts, eval_only=False):
    args = default_argument_parser().parse_args(
        ["--config-file", os.path.join(ROOT, "configs", cfg_file)]
        + (["--eval-only"] if eval_only else []) + opts)
    return train_net_torch.main(args, device="cpu")


def test_eval_hook_runs_during_training(tmp_path):
    name = _videos(tmp_path)
    cfg = vq_cfg(get_cfg, str(tmp_path / "out"))
    cfg.INPUT.N_FRAMES_PER_VIDEO_TRAIN, cfg.INPUT.N_FRAMES_PER_VIDEO_TEST = 2, 4
    cfg.SOLVER.IMS_PER_BATCH = 4
    cfg.DATASETS.TRAIN = cfg.DATASETS.TEST = (name,)
    cfg.TEST.EVALUATORS = "MSEEvaluator"
    cfg.TEST.EVAL_PERIOD = 3
    loader, _ = build_train_loader(cfg)
    trainer = Trainer(cfg, loader, device="cpu")
    calls = []

    def eval_fn():
        r = run_test(cfg, trainer.model, trainer.state.params, trainer.state.model_state)
        calls.append((trainer.iter, r))
        return r

    trainer.register_hooks([EvalHook(cfg.TEST.EVAL_PERIOD, eval_fn)])
    trainer.train(0, 7)
    # period 3 over 7 iters: after iters 3 and 6, plus the final one
    assert [it for it, _ in calls] == [2, 5, 6]
    assert all(np.isfinite(r["reconstruction"]["MSE"]) for _, r in calls)
    hist = trainer.storage.histories()["eval/reconstruction/MSE"].values()
    # the final evaluation lands at the storage's step after the loop, as in lvt_tpu
    assert [it for _, it in hist] == [2, 5, 7]
    assert [v for v, _ in hist] == [r["reconstruction"]["MSE"] for _, r in calls]


def test_eval_period_trains_with_eval_hook(tmp_path, monkeypatch):
    """The training CLI with TEST.EVAL_PERIOD 2 over 4 steps: the hook
    evaluates after step 2 and after the last, into metrics.json."""
    name = _latents(tmp_path)
    calls = []
    inner = defaults.run_test
    monkeypatch.setattr(defaults, "run_test",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    out = str(tmp_path / "vt")
    tr = _main("vt/DSFVT.yaml", VT_OPTS + [
        "DATASETS.TRAIN", f"('{name}',)", "DATASETS.TEST", f"('{name}',)",
        "TEST.EVAL_PERIOD", "2", "TEST.EVALUATORS", "BitsEvaluator",
        "SOLVER.MAX_ITER", "4", "OUTPUT_DIR", out])
    assert tr.state.step == 4 and len(calls) == 2
    assert any(isinstance(h, EvalHook) for h in tr._hooks)
    key = "eval/likelihood/bits_per_dim"
    stored = [v for v, _ in tr.storage.histories()[key].values()]
    assert len(stored) == 2 and all(0 < b < 2 * np.log2(16) for b in stored)
    # the writer (period 20) writes at the last step and after training: the
    # final evaluation reaches metrics.json
    with open(os.path.join(out, "metrics.json")) as f:
        logged = [r[key] for r in map(json.loads, f) if key in r]
    assert logged and logged[-1] == stored[-1]


@pytest.mark.parametrize("outcome", ["pass", "fail"])
def test_default_trainer_test_verifies_results(tmp_path, outcome):
    name = _videos(tmp_path)
    cfg = vq_cfg(get_cfg, str(tmp_path / "out"))
    cfg.INPUT.N_FRAMES_PER_VIDEO_TRAIN, cfg.INPUT.N_FRAMES_PER_VIDEO_TEST = 2, 4
    cfg.SOLVER.IMS_PER_BATCH = 4
    cfg.DATASETS.TRAIN = cfg.DATASETS.TEST = (name,)
    cfg.TEST.EVALUATORS = "MSEEvaluator"
    os.makedirs(cfg.OUTPUT_DIR)
    trainer = DefaultTrainer(cfg, device="cpu")
    mse = trainer.test()["reconstruction"]["MSE"]
    assert np.isfinite(mse)
    off = 0.0 if outcome == "pass" else 1.0 + abs(mse)
    cfg.TEST.EXPECTED_RESULTS = [["reconstruction", "MSE", mse + off, 1e-6 * abs(mse)]]
    if outcome == "pass":
        assert trainer.test()["reconstruction"]["MSE"] == mse
    else:
        with pytest.raises(SystemExit) as exc:
            trainer.test()
        assert exc.value.code == 1


def test_eval_only_cli_on_both_stages(tmp_path):
    """Stage 1 --eval-only after 2 training steps (the latest checkpoint of
    OUTPUT_DIR), then stage 2 --eval-only over the latents it wrote with the
    paired VQ-VAE read from stage 1's OUTPUT_DIR."""
    name = _videos(tmp_path, "cli_videos_seq")
    vq_out = str(tmp_path / "vq")
    opts = VQ_OPTS + ["DATASETS.TRAIN", f"('{name}',)", "DATASETS.TEST", f"('{name}',)",
                      "OUTPUT_DIR", vq_out]
    tr = _main("vqvae/PR-DVQVAE2.yaml", opts + ["SOLVER.MAX_ITER", "2"])
    assert tr.state.step == 2
    res = _main("vqvae/PR-DVQVAE2.yaml", opts, eval_only=True)
    assert set(res) == {"reconstruction", "latents"} and np.isfinite(res["reconstruction"]["MSE"])
    # the trained weights, not a fresh init: the same MSE as run_test on them
    again = run_test(tr.cfg, tr.model, tr.state.params, tr.state.model_state)
    assert again["reconstruction"]["MSE"] == res["reconstruction"]["MSE"]
    codes_root = os.path.join(vq_out, "inference", name)
    assert sorted(os.listdir(codes_root)) == ["video_0", "video_1"]
    code = np.load(os.path.join(codes_root, "video_1", "7.npy"))
    assert code.shape == (4, 8, 8) and code.dtype == np.int32 and 0 <= code.min() <= code.max() < 16

    # stage 2 over those latents; the paired VQ-VAE: stage 1's config and OUTPUT_DIR
    _register("cli_latents", lambda: get_latent_video_paths(codes_root, use_cache=False))
    vq_yaml = tmp_path / "vq.yaml"
    vq_yaml.write_text(tr.cfg.dump())
    vt_out = str(tmp_path / "vt")
    res = _main("vt/DSFVT.yaml", VT_OPTS + [
        "DATASETS.TEST", "('cli_latents',)",
        "TEST.EVALUATORS", "BitsEvaluator,VTSampler,FVDEvaluator",
        "TEST.VT_SAMPLER.VQ_VAE.CFG", str(vq_yaml),
        "TEST.VT_SAMPLER.VQ_VAE.ENCODER_WEIGHTS", vq_out,
        "TEST.VT_SAMPLER.VQ_VAE.GENERATOR_WEIGHTS", "",
        "TEST.VT_SAMPLER.VQ_VAE.CODEBOOK_WEIGHTS", "", "OUTPUT_DIR", vt_out], eval_only=True)
    assert set(res) == {"likelihood", "samples", "generation"}
    assert 0 < res["likelihood"]["bits_per_dim"] < 2 * np.log2(16)
    assert np.isfinite(res["generation"]["FVD_stub"])
    samples = os.path.join(vt_out, "inference", "samples", "cli_latents")
    assert sorted(os.listdir(samples)) == [f"video_{s}_{v}" for s in range(2) for v in range(2)]
    assert len(os.listdir(os.path.join(samples, "video_1_1"))) == 1 + 8


@pytest.mark.parametrize("stage", ["vqvae", "vt"])
def test_eval_only_refuses_missing_weights(tmp_path, stage):
    name = _latents(tmp_path, "missing_latents")
    missing = str(tmp_path / "nowhere" / "model_final.pth")
    if stage == "vqvae":
        opts = VQ_OPTS + ["MODEL.ENCODER.WEIGHTS", missing]
        cfg_file = "vqvae/PR-DVQVAE2.yaml"
    else:
        opts = VT_OPTS + NO_VQ_WEIGHTS + ["MODEL.GENERATOR.WEIGHTS", missing]
        cfg_file = "vt/DSFVT.yaml"
    with pytest.raises(FileNotFoundError, match="nowhere"):
        _main(cfg_file, opts + ["DATASETS.TEST", f"('{name}',)",
                                "OUTPUT_DIR", str(tmp_path / "out")], eval_only=True)


def test_eval_only_needs_the_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = default_argument_parser().parse_args(
        ["--config-file", os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"), "--eval-only",
         "OUTPUT_DIR", str(tmp_path / "out")])
    with pytest.raises(SystemExit):
        train_net_torch.main(args)
