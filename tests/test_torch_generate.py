"""scripts/generate_videos_torch.py's main on the CPU, at narrow widths: the
VT is built on the latent grid of the priming frames, the configured VQ-VAE
and VT weights are loaded (or refused), never replaced by random ones, and
the frames are written as scripts/generate_videos.py decodes them."""

import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import generate_videos_torch as gvt  # noqa: E402

from lvt_tpu_torch.checkpoint.convert import flatten  # noqa: E402

T, N_PRIME, SIZE = 4, 2, 32  # 32 x 32 frames: an 8 x 8 latent grid
VT_CFG = os.path.join(ROOT, "configs", "vt", "DSFVT.yaml")
_VT = "MODEL.AUTOREGRESSIVE.VT."
VT_OPTS = [_VT + "NV", "16", _VT + "D", "32", _VT + "DA", "16", _VT + "DE", "16",
           _VT + "STRIDE", f"({T},1,1)", _VT + "KERNEL", "(3,1,1)",
           _VT + "BLOCKS_E", "((1,4,4),(1,4,4))", _VT + "BLOCKS_D", "((1,4,4),(1,4,4))",
           _VT + "N_HEAD_E", "(2,2)", _VT + "N_HEAD_D", "(2,2)", "TPU.FUSED_LAYER", "False",
           "INPUT.N_FRAMES_PER_VIDEO_TEST", str(T), "INPUT.N_FRAMES_PER_VIDEO_TRAIN", str(T),
           "TEST.VT_SAMPLER.N_PRIME", str(N_PRIME)]
NO_VQ_WEIGHTS = ["TEST.VT_SAMPLER.VQ_VAE.ENCODER_WEIGHTS", "",
                 "TEST.VT_SAMPLER.VQ_VAE.GENERATOR_WEIGHTS", "",
                 "TEST.VT_SAMPLER.VQ_VAE.CODEBOOK_WEIGHTS", ""]


def _vq_yaml(tmp_path, scale_to_zeroone: bool) -> str:
    """PR-DVQVAE2 narrowed to NF 16 and a 16-entry codebook of width 16;
    without SCALE_TO_ZEROONE its pixel statistics are in [0, 255] units."""
    path = tmp_path / f"vqvae_{int(scale_to_zeroone)}.yaml"
    stats = "" if scale_to_zeroone else \
        "  PIXEL_MEAN: [127.5, 127.5, 127.5]\n  PIXEL_STD: [127.5, 127.5, 127.5]\n"
    path.write_text(
        f"_BASE_: {os.path.join(ROOT, 'configs', 'vqvae', 'PR-DVQVAE2.yaml')}\n"
        f"INPUT:\n  SCALE_TO_ZEROONE: {scale_to_zeroone}\n"
        f"MODEL:\n{stats}"
        "  ENCODER: {NF: 16, RES_CHANNELS: 8, OUT_CHANNELS: 16}\n"
        "  GENERATOR: {NF: 16, RES_CHANNELS: 8, IN_CHANNELS: 16}\n"
        "  CODEBOOK: {SIZE: 16, DIM: 16}\n")
    return str(path)


def _frames(tmp_path, name="prime", n=N_PRIME, seed=0) -> str:
    d = tmp_path / name
    d.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)).save(
            d / f"{i}.png")
    return str(d)


def _argv(video_dir, out_dir, vq_yaml, *opts):
    return ["--config-file", VT_CFG, "--video-dir", video_dir, "--seed", "3", *VT_OPTS,
            "TEST.VT_SAMPLER.VQ_VAE.CFG", vq_yaml, "OUTPUT_DIR", out_dir, *opts]


def _written(out_dir):
    return np.stack([np.asarray(Image.open(os.path.join(out_dir, f"{i}.png")).convert("RGB"))
                     for i in range(T)])


def test_frames_of_another_size_generate_and_are_scaled_by_the_vqvae_flag(tmp_path):
    """32 x 32 frames give an 8 x 8 latent grid, and the VT is built on it;
    with the VQ-VAE's INPUT.SCALE_TO_ZEROONE False the written pixels are
    clip(denormalize(decode(codes)), 0, 255), not clipped to [0, 1] first."""
    out_dir = str(tmp_path / "out")
    video, codes, primed, _ = gvt.main(
        _argv(_frames(tmp_path), out_dir, _vq_yaml(tmp_path, False), *NO_VQ_WEIGHTS),
        device="cpu")
    assert codes.shape == (1, 4, T, 8, 8) and primed.shape == (1, 4, N_PRIME, 8, 8)
    assert video.shape == (1, T, SIZE, SIZE, 3)
    vqvae, vq_params, vq_state, _, _ = gvt.build_models(
        gvt.load_config(VT_CFG, VT_OPTS + ["TEST.VT_SAMPLER.VQ_VAE.CFG",
                                           _vq_yaml(tmp_path, False)]), 3, "cpu", H=8, W=8)
    assert not vqvae.cfg.INPUT.SCALE_TO_ZEROONE
    with torch.no_grad():
        y = vqvae.denormalize(vqvae.decode(vq_params, vq_state,
                                           codes[0].permute(1, 2, 3, 0).contiguous()))
    want = y.clamp(0.0, 255.0).to(torch.uint8).numpy()
    assert not np.array_equal(want, (y.clamp(0.0, 1.0) * 255.0).to(torch.uint8).numpy())
    np.testing.assert_array_equal(_written(out_dir), want)


def test_configured_weights_are_loaded(tmp_path):
    """A VQ-VAE and a VT trained two steps each by tools/train_net_torch.py:
    main() reads the VQ-VAE through TEST.VT_SAMPLER.VQ_VAE.ENCODER_WEIGHTS
    and the VT from OUTPUT_DIR's latest checkpoint; the loaded tensors are
    the saved ones bit for bit, and the codes are generate()'s with the
    trainers' params in memory."""
    import train_net_torch
    from lvt_tpu_torch.data.catalog import DatasetCatalog
    from lvt_tpu_torch.data.datasets.bair import load_bair, register_bair
    from lvt_tpu_torch.data.datasets.latents import get_latent_video_paths, register_latents
    from lvt_tpu_torch.engine.defaults import default_argument_parser
    from lvt_tpu_torch.evaluation.vt_sampler import load_paired_vqvae, load_vt_weights

    rng = np.random.default_rng(1)
    frames_root = tmp_path / "frames"
    for v in range(2):
        (frames_root / "train" / f"video_{v}").mkdir(parents=True)
        for f in range(3):
            Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)).save(
                frames_root / "train" / f"video_{v}" / f"{f}.png")
    latents = tmp_path / "latents"
    for v in range(2):
        (latents / f"video_{v}").mkdir(parents=True)
        for f in range(T):
            np.save(latents / f"video_{v}" / f"{f}.npy", rng.integers(0, 16, (4, 8, 8)))
    for name, register, reset in (
            ("gen_toy_frames", lambda: register_bair("gen_toy_frames", str(frames_root), "train",
                                                     True),
             lambda: load_bair(str(frames_root), "train", True)),
            ("gen_toy_latents", lambda: register_latents("gen_toy_latents", str(latents)),
             lambda: get_latent_video_paths(str(latents), use_cache=False))):
        if name not in DatasetCatalog.list():
            register()
        else:  # a second run in one process: point the name at this run's files
            DatasetCatalog._REGISTERED[name] = reset
    parse = default_argument_parser().parse_args
    vq_yaml = _vq_yaml(tmp_path, True)
    common = ["SOLVER.MAX_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "2", "SOLVER.IMS_PER_BATCH",
              "2", "DATALOADER.NUM_WORKERS", "0"]
    vq_out, vt_out = str(tmp_path / "vq_out"), str(tmp_path / "vt_out")
    vq_tr = train_net_torch.main(parse(["--config-file", vq_yaml, *common, "DATASETS.TRAIN",
                                        "('gen_toy_frames',)", "OUTPUT_DIR", vq_out]),
                                 device="cpu")
    vt_tr = train_net_torch.main(parse(["--config-file", VT_CFG, *VT_OPTS, *common,
                                        "DATASETS.TRAIN", "('gen_toy_latents',)",
                                        "OUTPUT_DIR", vt_out]), device="cpu")

    opts = ["TEST.VT_SAMPLER.VQ_VAE.ENCODER_WEIGHTS", vq_out,
            "TEST.VT_SAMPLER.VQ_VAE.GENERATOR_WEIGHTS", "",
            "TEST.VT_SAMPLER.VQ_VAE.CODEBOOK_WEIGHTS", ""]
    prime = _frames(tmp_path)
    _, codes, _, _ = gvt.main(_argv(prime, vt_out, vq_yaml, *opts), device="cpu")

    cfg = gvt.load_config(VT_CFG, VT_OPTS + ["TEST.VT_SAMPLER.VQ_VAE.CFG", vq_yaml,
                                             "OUTPUT_DIR", vt_out] + opts)
    vqvae, vq_params, vq_state, _, loaded = load_paired_vqvae(cfg, torch.Generator(), "cpu")
    assert loaded
    for tree, trained in ((vq_params, vq_tr.state.params), (vq_state, vq_tr.state.model_state)):
        got, want = flatten(tree), flatten(trained)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k].detach()), k
    vt, vt_params = gvt.build_vt(cfg, torch.Generator(), "cpu", 8, 8)
    got, want = flatten(load_vt_weights(cfg, vt_params)), flatten(vt_tr.state.params)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k].detach()), k

    frames = torch.from_numpy(gvt.load_priming_frames(prime, N_PRIME))[None]
    _, in_memory, _, _ = gvt.generate(
        vqvae, vq_tr.state.params, vq_tr.state.model_state, vt, vt_tr.state.params, frames,
        N_PRIME, torch.Generator().manual_seed(3))
    assert torch.equal(codes, in_memory)


def test_configured_weights_that_cannot_be_read_are_refused(tmp_path):
    """A configured path that does not exist raises FileNotFoundError naming
    its key, and a .pth that is no state dict raises ValueError naming its
    key; neither samples from random weights. A reference .pth that can be
    read is loaded: the codebook of a netC file (DVQEmbedding's ``ve.<i>``
    keys, wrapped as fvcore writes it) is the one the VQ-VAE decodes with."""
    prime, vq_yaml = _frames(tmp_path), _vq_yaml(tmp_path, True)
    out_dir = str(tmp_path / "out")
    pth = tmp_path / "model_final.pth"
    pth.write_bytes(b"")
    missing = str(tmp_path / "nowhere.pt")
    with pytest.raises(FileNotFoundError, match="ENCODER_WEIGHTS"):
        gvt.main(_argv(prime, out_dir, vq_yaml, *NO_VQ_WEIGHTS[2:],
                       "TEST.VT_SAMPLER.VQ_VAE.ENCODER_WEIGHTS", missing), device="cpu")
    with pytest.raises(ValueError, match="CODEBOOK_WEIGHTS"):
        gvt.main(_argv(prime, out_dir, vq_yaml, *NO_VQ_WEIGHTS[:4],
                       "TEST.VT_SAMPLER.VQ_VAE.CODEBOOK_WEIGHTS", str(pth)), device="cpu")
    with pytest.raises(FileNotFoundError, match="MODEL.GENERATOR.WEIGHTS"):
        gvt.main(_argv(prime, out_dir, vq_yaml, *NO_VQ_WEIGHTS,
                       "MODEL.GENERATOR.WEIGHTS", missing), device="cpu")
    with pytest.raises(ValueError, match="MODEL.GENERATOR.WEIGHTS"):
        gvt.main(_argv(prime, out_dir, vq_yaml, *NO_VQ_WEIGHTS,
                       "MODEL.GENERATOR.WEIGHTS", str(pth)), device="cpu")
    assert not os.path.exists(out_dir)  # nothing was sampled

    from lvt_tpu_torch.evaluation.vt_sampler import load_paired_vqvae

    rng = np.random.default_rng(2)
    emb = [rng.standard_normal((16, 4)).astype(np.float32) for _ in range(4)]
    netc = tmp_path / "netC.pth"
    torch.save({"model": {f"ve.{i}.embedding.weight": torch.from_numpy(e)
                          for i, e in enumerate(emb)}}, netc)
    opts = [*NO_VQ_WEIGHTS[:4], "TEST.VT_SAMPLER.VQ_VAE.CODEBOOK_WEIGHTS", str(netc)]
    _, codes, _, _ = gvt.main(_argv(prime, out_dir, vq_yaml, *opts), device="cpu")
    assert codes.shape == (1, 4, T, 8, 8) and os.path.exists(os.path.join(out_dir, "0.png"))
    cfg = gvt.load_config(VT_CFG, VT_OPTS + ["TEST.VT_SAMPLER.VQ_VAE.CFG", vq_yaml] + opts)
    _, _, state, _, loaded = load_paired_vqvae(cfg, torch.Generator(), "cpu")
    assert loaded and torch.equal(state["netC"]["embedding"], torch.from_numpy(np.stack(emb)))
    assert torch.equal(state["netC"]["running_sum"], state["netC"]["embedding"])
