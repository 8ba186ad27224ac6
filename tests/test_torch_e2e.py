"""The two-stage chain and its tools on the CPU, at narrow widths:

* tools/e2e_demo_torch.py in both modes (BAIR, and class-conditional
  K-DVQVAE -> KDSFVT with CLASS_NUM 600), 2 + 2 steps: codes extracted, the
  PNGs written, kernel 6's check run, and in the class-conditional mode the
  rollouts of two classes differ; its datasets are tools/e2e_demo.py's, pixel
  for pixel;
* ops/vq.py's near-tie counter on an injected exact tie and a far miss;
* scripts/generate_videos_torch.py --img-size: the priming codes of 40 x 48
  frames cropped and resized to 32 x 32 equal lvt_tpu's (its encode after
  lvt_tpu.data.preprocess.center_crop_resize), the VQ-VAE's weights carried
  across with from_jax_vqvae; a difference is allowed only at a float64
  near-tie (ROADMAP queue 3);
* tools/bench_pipeline_torch.py --gen and --loader-only at a tiny size, the
  native reader beside PIL;
* utils/collect_env.collect_env_info with no GPU.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lvt_tpu.config import get_cfg as jax_get_cfg
from lvt_tpu.data.preprocess import center_crop_resize as jax_crop_resize
from lvt_tpu.models.vqvae import VQVAE as JaxVQVAE
from lvt_tpu_torch.checkpoint import from_jax_vqvae, save_checkpoint
from lvt_tpu_torch.data.preprocess import center_crop_resize
from lvt_tpu_torch.models.vqvae import VQVAE
from lvt_tpu_torch.ops import vq
from lvt_tpu_torch.utils.collect_env import collect_env_info

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import bench_pipeline_torch  # noqa: E402
import e2e_demo_torch  # noqa: E402
import generate_videos_torch as gvt  # noqa: E402

# stage 2 and 4 overrides: PR-DVQVAE2 / K-DVQVAE at NF 8 with a 2 x 8
# codebook, the VT at d 24 on the 8 x 8 latent grid of 32 x 32 frames
VQ_OPTS = ["MODEL.ENCODER.NF", "8", "MODEL.ENCODER.RES_CHANNELS", "4",
           "MODEL.ENCODER.N_LAYERS", "1", "MODEL.ENCODER.OUT_CHANNELS", "8",
           "MODEL.GENERATOR.NF", "8", "MODEL.GENERATOR.RES_CHANNELS", "4",
           "MODEL.GENERATOR.N_LAYERS", "1", "MODEL.GENERATOR.IN_CHANNELS", "8",
           "MODEL.CODEBOOK.NUM", "2", "MODEL.CODEBOOK.SIZE", "8", "MODEL.CODEBOOK.DIM", "8",
           "DATALOADER.NUM_WORKERS", "0", "SOLVER.IMS_PER_BATCH", "4"]
_VT = "MODEL.AUTOREGRESSIVE.VT."
VT_OPTS = [_VT + "NC", "2", _VT + "NV", "8", _VT + "D", "24", _VT + "DA", "12", _VT + "DE", "12",
           _VT + "BLOCKS_E", "((1,8,8),)", _VT + "N_HEAD_E", "(2,)",
           _VT + "BLOCKS_D", "((1,8,8),)", _VT + "N_HEAD_D", "(2,)", "DATALOADER.NUM_WORKERS", "0",
           "SOLVER.IMS_PER_BATCH", "4"]


def _e2e(tmp_path, *mode):
    return e2e_demo_torch.main(
        ["--device", "cpu", "--workdir", str(tmp_path), "--iters1", "2", "--iters2", "2",
         "--n-videos", "2", "--size", "32", *mode,
         "--vq-opts", *VQ_OPTS, "--vt-opts", *VT_OPTS])


@pytest.mark.parametrize("mode", ["bair", "class-conditional"])
def test_e2e_demo_runs_the_chain(tmp_path, mode):
    cc = mode == "class-conditional"
    res = _e2e(tmp_path, *(["--class-conditional"] if cc else []))
    codes_root = tmp_path / ("vqvae_out_cls" if cc else "vqvae_out") / "inference" / "demo_train"
    latents = sorted(codes_root.rglob("*.npy"))
    n_videos = 2 * (3 if cc else 1)
    assert len(latents) == n_videos * 16 and np.load(latents[0]).shape == (2, 8, 8)
    assert sorted(os.listdir(res["generated_dir"])) == sorted(f"{i}.png" for i in range(16))
    frame = np.asarray(Image.open(os.path.join(res["generated_dir"], "0.png")))
    assert frame.shape == (32, 32, 3)
    assert res["codes"].shape == (1, 2, 16, 8, 8)
    assert int(res["codes"].min()) >= 0 and int(res["codes"].max()) < 8
    assert res["frames"].shape == (16, 32, 32, 3)
    assert np.isfinite(res["mse"]) and np.isfinite(res["bits_per_dim"])
    assert res["kernel6"] == {"indices": n_videos * 16 * 64 * 2, "differ": 0, "far": 0,
                              "kernel": False}
    assert not any(res["launches"].values())  # no kernel on the CPU
    if cc:
        assert res["class_codes_differ"] > 0


def test_demo_datasets_are_lvt_tpus(tmp_path):
    spec = importlib.util.spec_from_file_location("e2e_demo", os.path.join(ROOT, "tools",
                                                                          "e2e_demo.py"))
    jdemo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jdemo)
    for name, args in (("make_dataset", (2,)), ("make_class_dataset", (1,))):
        getattr(e2e_demo_torch, name)(str(tmp_path / "torch" / name), *args, n_frames=3)
        getattr(jdemo, name)(str(tmp_path / "jax" / name), *args, n_frames=3)
    got = sorted(p.relative_to(tmp_path / "torch") for p in (tmp_path / "torch").rglob("*.png"))
    want = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.png"))
    assert got == want and len(got) == 2 * 3 + 3 * 3
    for p in got:
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "torch" / p)),
                                      np.asarray(Image.open(tmp_path / "jax" / p)))


def test_near_tie_counter_classifies_a_tie_and_a_far_miss():
    g = torch.Generator().manual_seed(0)
    z = torch.randn(64, 2, 4, generator=g)
    codebooks = torch.randn(2, 16, 4, generator=g)
    codebooks[1, 9] = codebooks[1, 5]  # codes 5 and 9 of sub-codebook 1 tie exactly
    z[7, 1] = codebooks[1, 5] + 1e-3
    want = vq.nearest_indices_grouped_plain(z, codebooks)
    assert int(want[7, 1]) == 5
    assert vq.index_differences(want, want, z, codebooks) == (0, 0)
    tie = want.clone()
    tie[7, 1] = 9
    assert vq.index_differences(tie, want, z, codebooks) == (1, 0)
    far = tie.clone()
    far[3, 0] = (int(want[3, 0]) + 1) % 16
    assert vq.index_differences(far, want, z, codebooks) == (2, 1)


def test_img_size_priming_codes_equal_lvt_tpus(tmp_path):
    vq_yaml = tmp_path / "vq.yaml"
    vq_yaml.write_text(
        f"_BASE_: {os.path.join(ROOT, 'configs', 'vqvae', 'PR-DVQVAE2.yaml')}\n"
        "MODEL:\n  ENCODER: {NF: 32, RES_CHANNELS: 16, OUT_CHANNELS: 32}\n"
        "  GENERATOR: {NF: 32, RES_CHANNELS: 16, IN_CHANNELS: 32}\n"
        "  CODEBOOK: {SIZE: 16, DIM: 32}\n")
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(str(vq_yaml))
    jq = JaxVQVAE(jcfg)
    jp, js = jq.init(jax.random.key(1))
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (5, 40, 48, 3), dtype=np.uint8)
    prime = tmp_path / "prime"
    prime.mkdir()
    for i, f in enumerate(frames):
        Image.fromarray(f).save(prime / f"{i}.png")

    # lvt_tpu: scripts/generate_videos.py's encode_priming with --img-size 32
    x = jax_crop_resize(jnp.asarray(frames, jnp.float32) / 255.0, 32)
    want = np.asarray(jnp.transpose(jq.encode(jp, js, jq.normalize(x)), (3, 0, 1, 2)))

    # the port: the command line, the VQ-VAE read from a checkpoint of lvt_tpu's weights
    to_np = lambda t: jax.tree_util.tree_map(np.array, t)  # noqa: E731
    tp, ts = from_jax_vqvae(to_np(jp), to_np(js))
    save_checkpoint(str(tmp_path / "vq_ckpt"), 0, {"params": tp, "model_state": ts})
    T = 8
    argv = ["--config-file", os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"),
            "--video-dir", str(prime), "--img-size", "32",
            _VT + "NV", "16", _VT + "D", "32", _VT + "DA", "16", _VT + "DE", "16",
            _VT + "STRIDE", f"({T},1,1)", _VT + "KERNEL", "(3,1,1)",
            _VT + "BLOCKS_E", "((1,4,4),(1,4,4))", _VT + "BLOCKS_D", "((1,4,4),(1,4,4))",
            _VT + "N_HEAD_E", "(2,2)", _VT + "N_HEAD_D", "(2,2)", "TPU.FUSED_LAYER", "False",
            "INPUT.N_FRAMES_PER_VIDEO_TEST", str(T), "TEST.VT_SAMPLER.VQ_VAE.CFG", str(vq_yaml),
            "TEST.VT_SAMPLER.VQ_VAE.ENCODER_WEIGHTS", str(tmp_path / "vq_ckpt"),
            "TEST.VT_SAMPLER.VQ_VAE.GENERATOR_WEIGHTS", "",
            "TEST.VT_SAMPLER.VQ_VAE.CODEBOOK_WEIGHTS", "", "OUTPUT_DIR", str(tmp_path / "out")]
    video, codes, primed, _ = gvt.main(argv, device="cpu")
    assert video.shape == (1, T, 32, 32, 3) and primed.shape == (1, 4, 5, 8, 8)
    got = primed[0].numpy()
    if not np.array_equal(got, want):
        tq = VQVAE(jcfg)
        tx = center_crop_resize(torch.from_numpy(frames).float() / 255.0, 32)
        with torch.no_grad():
            z = tq.encode_features(tp, ts, tq.normalize(tx))[0].reshape(-1, 4, 8)
        flat = lambda a: torch.from_numpy(a.transpose(1, 2, 3, 0).reshape(-1, 4))  # noqa: E731
        n_diff, n_far = vq.index_differences(flat(got), flat(want), z, ts["netC"]["embedding"])
        assert n_far == 0 and n_diff <= max(1, int(vq.NEAR_TIE_SHARE * want.size)), (n_diff,
                                                                                    n_far)


def test_bench_pipeline_gen_and_loader_only(tmp_path, capsys):
    wd = str(tmp_path)
    bench_pipeline_torch.main(["--gen", "--workdir", wd, "--n-videos", "3",
                               "--n-frame-videos", "1"])
    assert len(list((tmp_path / "latents").rglob("*.npy"))) == 3 * 16
    assert len(list((tmp_path / "frames").rglob("*.png"))) == 16
    vt = bench_pipeline_torch.main(["--loader-only", "--workdir", wd, "--config", "vt",
                                    "--batch", "2", "--batches", "2", "--workers", "0"])
    vqvae = bench_pipeline_torch.main(["--loader-only", "--workdir", wd, "--config", "vqvae",
                                       "--batch", "4", "--batches", "2", "--workers", "0"])
    for out, shape in ((vt, [2, 4, 16, 16, 16]), (vqvae, [4, 64, 64, 3])):
        for kind in ("native", "pil"):
            assert out[kind]["batch_shape"] == shape and out[kind]["batches_per_sec"] > 0
    assert '"mode": "loader_only"' in capsys.readouterr().out


def test_collect_env_info_without_a_gpu():
    info = collect_env_info()
    assert "torch" in info and "nvidia-smi name, power.limit" in info and "nvcc" in info
    assert f"CUDA available{' ' * 2}" in info or "CUDA available" in info
    assert "native lvt_io" in info
