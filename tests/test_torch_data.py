"""The port's latent-video data path held to lvt_tpu's on the same files on
disk (exact equality throughout: the data are integer codes):

* the latent dataset dicts (the CodesExtractor layout walk and its cache);
* the mapper's test-mode (head crop) and train-mode (seeded random crop)
  arrays;
* the training sampler's index stream and the collated first batches of
  build_train_loader, in this process and from worker processes.
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
    with pytest.raises(NotImplementedError):
        DatasetMapper(_cfg(get_cfg), is_train=True)({"image_path": "x.png"})


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


def test_collate_equal_and_refuses_mixed_schemas():
    samples = [{"video": np.full((2, 3), i, np.int32), "class": np.int32(i), "video_idx": i}
               for i in range(3)]
    got, want = tbuild.collate(samples), jbuild.collate(samples)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    with pytest.raises(ValueError):
        tbuild.collate([{"video": 1}, {"video": 1, "class": 2}])
