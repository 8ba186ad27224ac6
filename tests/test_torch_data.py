"""The port's data path held to lvt_tpu's on the same files on disk (exact
equality throughout: integer codes, and frames decoded from the same PNGs):

* the latent dataset dicts (the CodesExtractor layout walk and its cache);
* the mapper's test-mode (head crop) and train-mode (seeded random crop)
  arrays;
* the training sampler's index stream and the collated first batches of
  build_train_loader, in this process and from worker processes;
* the image datasets (the VQ-VAE's): the BAIR and Kinetics walks, and the
  mapper's image, image_path, image_names and image_sequence branches.
"""

import random

import numpy as np
import pytest

import lvt_tpu.data.build as jbuild
import lvt_tpu.data.datasets.latents as jlat
from lvt_tpu.config import get_cfg as jax_get_cfg
from lvt_tpu.data.mapper import DatasetMapper as JaxMapper
from lvt_tpu.data.samplers import TrainingSampler as JaxSampler
from lvt_tpu_torch.config import get_cfg
from lvt_tpu_torch.data import build as tbuild
from lvt_tpu_torch.data.datasets import latents as tlat
from lvt_tpu_torch.data.mapper import DatasetMapper
from lvt_tpu_torch.data.samplers import TrainingSampler


@pytest.fixture
def latent_root(tmp_path, rng):
    """Latent videos of 6 to 9 frames of (4, 5, 6) codes, the CodesExtractor
    layout, with an AppleDouble file the walk must skip and a nested class
    folder level."""
    root = tmp_path / "latents"
    for v, n in enumerate((6, 9, 7, 8, 6)):
        d = root / "cls_a" / f"video_{v}"
        d.mkdir(parents=True)
        for f in range(n):
            np.save(d / f"{f}.npy", rng.integers(0, 512, (4, 5, 6)).astype(np.int64))
    (root / "cls_a" / "video_0" / "._0.npy").write_bytes(b"\0")
    return str(root)


def _cfg(get, n_train=6, n_test=6):
    cfg = get()
    cfg.MODEL.META_ARCHITECTURE = "VideoTransformerModel"
    cfg.INPUT.N_FRAMES_PER_VIDEO_TRAIN = n_train
    cfg.INPUT.N_FRAMES_PER_VIDEO_TEST = n_test
    cfg.SOLVER.IMS_PER_BATCH = 2
    cfg.DATALOADER.NUM_WORKERS = 2
    cfg.SEED = 7
    return cfg


@pytest.mark.parametrize("use_cache", [False, True])
def test_latent_dataset_dicts_equal(latent_root, use_cache):
    want = jlat.get_latent_video_paths(latent_root, use_cache=use_cache)
    got = tlat.get_latent_video_paths(latent_root, use_cache=use_cache)
    assert got == want and len(got) == 5


@pytest.mark.parametrize("n_frames", [6, 8])
def test_mapper_test_mode_equal(latent_root, n_frames):
    dicts = jlat.get_latent_video_paths(latent_root, use_cache=False)
    jm = JaxMapper(_cfg(jax_get_cfg, n_test=n_frames), is_train=False)
    tm = DatasetMapper(_cfg(get_cfg, n_test=n_frames), is_train=False)
    for d in dicts:
        want, got = jm(d), tm(d)
        if want is None:  # shorter than n_frames: both refuse it
            assert got is None
            continue
        assert set(got) == set(want)
        assert got["video"].dtype == np.int32 and got["video"].shape == (4, n_frames, 5, 6)
        np.testing.assert_array_equal(got["video"], want["video"])


def test_mapper_train_mode_crop_equal(latent_root):
    dicts = jlat.get_latent_video_paths(latent_root, use_cache=False)
    jm, tm = JaxMapper(_cfg(jax_get_cfg), is_train=True), DatasetMapper(_cfg(get_cfg),
                                                                        is_train=True)
    for seed, d in enumerate(dicts * 2):
        random.seed(seed)
        want = jm(d)
        random.seed(seed)
        np.testing.assert_array_equal(tm(d)["video"], want["video"])


def test_mapper_refuses_image_datasets():
    """The mapper refused image dicts until the image branches were ported;
    what it still refuses is a frame that is not on disk, as lvt_tpu does."""
    for mapper in (DatasetMapper(_cfg(get_cfg), is_train=True),
                   JaxMapper(_cfg(jax_get_cfg), is_train=True)):
        with pytest.raises(FileNotFoundError):
            mapper({"image_path": "x.png"})


@pytest.fixture
def frame_root(tmp_path, rng):
    """PNG frames in the BAIR layout, <root>/train/video_<v>/<f>.png, and a
    Kinetics-style class level, <root>/ktrain/<label>/video_0/<f>.png."""
    from PIL import Image

    from lvt_tpu_torch.utils.labels import KINETICS_LABEL_IDX

    root = tmp_path / "frames"
    label = sorted(KINETICS_LABEL_IDX)[3]
    for d, n in [(root / "train" / f"video_{v}", n) for v, n in enumerate((7, 5, 6))] + \
            [(root / "ktrain" / label / "video_0", 6)]:
        d.mkdir(parents=True)
        for f in range(n):
            Image.fromarray(rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)).save(d / f"{f}.png")
    (root / "train" / "video_0" / "._0.png").write_bytes(b"\0")
    return str(root)


def _image_cfg(get, scale=True, fmt="RGB", n=5):
    cfg = get()
    cfg.MODEL.META_ARCHITECTURE = "VQVAEModel"
    cfg.INPUT.FORMAT, cfg.INPUT.SCALE_TO_ZEROONE = fmt, scale
    cfg.INPUT.N_FRAMES_PER_VIDEO_TRAIN = cfg.INPUT.N_FRAMES_PER_VIDEO_TEST = n
    return cfg


@pytest.mark.parametrize("load_images", [True, False], ids=["frames", "videos"])
def test_image_dataset_dicts_equal(frame_root, load_images):
    import lvt_tpu.data.datasets.bair as jbair
    import lvt_tpu.data.datasets.kinetics as jkin
    from lvt_tpu_torch.data.datasets import bair as tbair
    from lvt_tpu_torch.data.datasets import kinetics as tkin

    for phase, jmod, tmod in (("train", jbair.load_bair, tbair.load_bair),
                              ("ktrain", jkin.load_kinetics, tkin.load_kinetics)):
        got = tmod(frame_root, phase, load_images)
        assert got == jmod(frame_root, phase, load_images)  # the second walk reads the cache
        assert len(got) == {("train", True): 18, ("train", False): 3}.get(
            (phase, load_images), 6 if load_images else 1)
        assert ("class" in got[0]) == (phase == "ktrain")


def test_builtin_image_datasets_are_registered():
    from lvt_tpu.data import DatasetCatalog as JaxCatalog
    from lvt_tpu_torch.data import DatasetCatalog

    assert set(JaxCatalog.list()) <= set(DatasetCatalog.list())
    assert {"bair_train", "bair_test_seq", "kinetics_train_seq"} <= set(DatasetCatalog.list())


@pytest.mark.parametrize("scale,fmt", [(True, "RGB"), (False, "RGB"), (True, "L"), (True, "BGR")])
def test_mapper_image_branches_equal(frame_root, rng, scale, fmt):
    from lvt_tpu_torch.data.datasets.bair import load_bair

    frames, videos = load_bair(frame_root, "train", True), load_bair(frame_root, "train", False)
    raw = rng.integers(0, 256, (12, 10, 3)).astype(np.uint8)
    raw_seq = rng.integers(0, 256, (7, 12, 10, 3)).astype(np.uint8)
    for is_train in (True, False):
        jm = JaxMapper(_image_cfg(jax_get_cfg, scale, fmt), is_train=is_train)
        tm = DatasetMapper(_image_cfg(get_cfg, scale, fmt), is_train=is_train)
        dicts = [frames[0], frames[-1], {"image": raw, "class": 3}, *videos,
                 {"image_sequence": raw_seq, "video_idx": 0}]
        for seed, d in enumerate(dicts):
            random.seed(seed)
            want = jm(d)
            random.seed(seed)
            got = tm(d)
            if want is None:
                assert got is None
                continue
            assert set(got) == set(want)
            key = "image" if "image" in want else "image_sequence"
            assert got[key].dtype == np.float32 and got[key].shape == want[key].shape
            np.testing.assert_array_equal(got[key], want[key])
            if "class" in want:
                assert got["class"] == want["class"] and got["class"].dtype == np.int32
    assert got["image_sequence"].shape == (5, 12, 10, 3)  # the raw sequence, head-cropped


def test_mapper_code_sequences_for_the_vt_equal(rng):
    """Pre-extracted codes handed in as an image_sequence become "video" for
    a VT config, and the frame key goes."""
    seq = rng.integers(0, 512, (6, 4, 5, 6))
    want = JaxMapper(_cfg(jax_get_cfg), is_train=False)({"image_sequence": seq})
    got = DatasetMapper(_cfg(get_cfg), is_train=False)({"image_sequence": seq})
    assert set(got) == set(want) == {"video"}
    np.testing.assert_array_equal(got["video"], want["video"])


def test_image_train_loader_batches(frame_root, monkeypatch):
    """build_train_loader on frames: float32 (b, H, W, C) batches in [0, 1]
    under "image", the file names kept as a list."""
    from lvt_tpu_torch.data.datasets.bair import load_bair

    dicts = load_bair(frame_root, "train", True)
    monkeypatch.setattr(tbuild, "get_dataset_dicts", lambda names: dicts)
    cfg = _image_cfg(get_cfg)
    cfg.SOLVER.IMS_PER_BATCH, cfg.DATALOADER.NUM_WORKERS, cfg.SEED = 4, 2, 7
    batch = _batches(tbuild.build_train_loader(cfg)[0], 1)[0]
    assert batch["image"].shape == (4, 12, 10, 3) and batch["image"].dtype == np.float32
    assert 0.0 <= batch["image"].min() and batch["image"].max() <= 1.0
    assert len(batch["image_path"]) == 4


def test_training_sampler_stream_equal():
    a, b = iter(JaxSampler(7, seed=3)), iter(TrainingSampler(7, seed=3))
    assert [int(next(a)) for _ in range(30)] == [int(next(b)) for _ in range(30)]


def _batches(loader, n):
    it = iter(loader)
    return [next(it) for _ in range(n)]


def test_train_loader_batches_equal(latent_root, monkeypatch):
    """Random crops (N_FRAMES_PER_VIDEO_TRAIN = 6: the shortest video fits,
    longer ones crop at random) draw from the python RNG, so both loaders map
    in this process (lvt_tpu with one loader thread, the port with
    NUM_WORKERS 0) from one seed."""
    dicts = jlat.get_latent_video_paths(latent_root, use_cache=False)
    monkeypatch.setattr(jbuild, "get_dataset_dicts", lambda names: dicts)
    monkeypatch.setattr(tbuild, "get_dataset_dicts", lambda names: dicts)
    jcfg, tcfg = _cfg(jax_get_cfg), _cfg(get_cfg)
    jcfg.DATALOADER.NUM_WORKERS, tcfg.DATALOADER.NUM_WORKERS = 1, 0
    random.seed(0)
    jit = iter(jbuild.build_train_loader(jcfg)[0])
    want = [next(jit) for _ in range(4)]
    jit.close()
    random.seed(0)
    got = _batches(tbuild.build_train_loader(tcfg)[0], 4)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        np.testing.assert_array_equal(g["video"], w["video"])
        assert g["video_idx"] == w["video_idx"]


def test_train_loader_worker_processes_equal_in_process(latent_root, monkeypatch):
    """Two worker processes give the batches the in-process loader gives, in
    the sampler's order (on the 6-frame videos, whose crop is the whole
    video, so no draw of the python RNG is involved)."""
    dicts = [d for d in jlat.get_latent_video_paths(latent_root, use_cache=False)
             if len(d["latent_names"]) == 6]
    assert len(dicts) == 2
    monkeypatch.setattr(tbuild, "get_dataset_dicts", lambda names: dicts)
    cfg = _cfg(get_cfg)
    cfg.DATALOADER.NUM_WORKERS = 0
    want = _batches(tbuild.build_train_loader(cfg)[0], 5)
    cfg.DATALOADER.NUM_WORKERS = 2
    got = _batches(tbuild.build_train_loader(cfg)[0], 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["video"], w["video"])
        assert g["video_idx"] == w["video_idx"]


def _refuse_first(d):
    return None if d["i"] == 0 else d["i"]


def test_worker_processes_draw_different_replacements():
    """A refused sample is replaced by a random draw: two worker processes
    each replacing sample 0 draw from generators of their own (seeded from
    their DataLoader seeds), not the same sequence; one generator serves a
    loader without workers."""
    import torch

    dataset = tbuild._MappedDataset([{"i": i} for i in range(1000)], _refuse_first)
    loader = torch.utils.data.DataLoader(
        dataset, batch_size=1, sampler=[0, 0], num_workers=2, collate_fn=lambda x: x[0],
        generator=torch.Generator().manual_seed(0))
    first, second = list(loader)
    assert first != second
    in_process = tbuild._MappedDataset([{"i": i} for i in range(1000)], _refuse_first)
    assert in_process[0] != in_process[0]  # the one generator moves on


def test_collate_equal_and_refuses_mixed_schemas():
    samples = [{"video": np.full((2, 3), i, np.int32), "class": np.int32(i), "video_idx": i}
               for i in range(3)]
    got, want = tbuild.collate(samples), jbuild.collate(samples)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    with pytest.raises(ValueError):
        tbuild.collate([{"video": 1}, {"video": 1, "class": 2}])
