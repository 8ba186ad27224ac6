"""The port's native IO library and the data path around it, held to lvt_tpu
on the same numpy-seeded files:

* lvt_tpu_torch/native/lvt_io.cpp is byte-equal to lvt_tpu's; the library
  builds into build/lvt_tpu_torch/ under a digest of the source, and where it
  cannot be built the first call logs one WARNING and the readers return
  None;
* read_png_rgb equals PIL's convert("RGB") and lvt_tpu.native for RGB, gray,
  RGBA and palette PNGs, and returns None on a corrupt file;
  load_npy_sequence_i32 equals lvt_tpu's for int64 and int32 files;
* BAIR TFRecords (written here in the layout tests/test_cli_scripts.py uses)
  through scripts/convert_bair.py: the port's walkers give lvt_tpu's dataset
  dicts, and its mapper, reading the frames natively, gives lvt_tpu's arrays
  bit for bit, as it does on a latent tree;
* scripts/convert_kinetics_torch.py --preprocess device (on the CPU, ffmpeg
  stubbed) within one step of scripts/convert_kinetics.py's device path.
"""

import filecmp
import importlib.util
import logging
import os

import numpy as np
import pytest
import torch
from PIL import Image

import lvt_tpu.data.datasets.bair as jbair
import lvt_tpu_torch.data.datasets.bair as tbair
import lvt_tpu_torch.data.mapper as tmapper
from lvt_tpu import native as jnative
from lvt_tpu.config import get_cfg as jax_get_cfg
from lvt_tpu.data.mapper import DatasetMapper as JaxMapper
from lvt_tpu_torch import native
from lvt_tpu_torch.config import get_cfg
from lvt_tpu_torch.data.mapper import DatasetMapper
from test_cli_scripts import make_example, write_tfrecord

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """One PNG of each colour type the converters may meet, and a corrupt one."""
    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(d / "rgb.png")
    Image.fromarray(rng.integers(0, 256, (16, 20), dtype=np.uint8), mode="L").save(d / "gray.png")
    Image.fromarray(rng.integers(0, 256, (8, 9, 4), dtype=np.uint8), mode="RGBA").save(
        d / "rgba.png")
    Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE).save(d / "palette.png")
    (d / "corrupt.png").write_bytes(b"\x89PNG\r\n\x1a\n not a png at all")
    return d


@pytest.fixture(scope="module")
def bair_root(tmp_path_factory):
    """Two train videos of 30 frames and one test video, as TFRecords,
    through scripts/convert_bair.py; returns <data_dir>/processed_data."""
    data = tmp_path_factory.mktemp("bair")
    rng = np.random.default_rng(1)
    convert_bair = _script("convert_bair")
    for phase, n in (("train", 2), ("test", 1)):
        src = data / "softmotion30_44k" / phase
        src.mkdir(parents=True)
        videos = [rng.integers(0, 256, (30, 64, 64, 3), dtype=np.uint8) for _ in range(n)]
        write_tfrecord(str(src / "traj_0_to_1.tfrecords"),
                       [make_example([(f"{i}/image_aux1/encoded", v[i].tobytes())
                                      for i in range(30)]) for v in videos])
        convert_bair.convert_phase(str(data), phase)
    return str(data / "processed_data")


def test_source_is_lvt_tpus_and_builds_under_a_digest():
    assert filecmp.cmp(native.SOURCE, os.path.join(ROOT, "lvt_tpu", "native", "lvt_io.cpp"),
                       shallow=False)
    assert native.available()
    assert os.path.dirname(native.LIBRARY.path) == os.path.join(ROOT, "build", "lvt_tpu_torch")
    assert os.path.basename(native.LIBRARY.path).startswith("liblvt_io_")
    assert native.LIBRARY.build() == native.LIBRARY.path  # found, not rebuilt


def test_no_compiler_warns_once_and_reads_nothing(monkeypatch, tmp_path, pngs, caplog):
    def missing(*args, **kwargs):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native.subprocess, "run", missing)
    monkeypatch.setattr(native, "LIBRARY", native.NativeIO())
    # the capture hangs on native's own logger, which stops there: a
    # setup_logger of an earlier test (propagate off on the package's
    # logger) cannot hide the record from it, nor the root hand it over twice
    monkeypatch.setattr(native.logger, "propagate", False)
    native.logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING, logger=native.__name__):
            assert native.read_png_rgb(str(pngs / "rgb.png")) is None
            assert native.load_npy_sequence_i32([str(pngs / "rgb.png")], (1,)) is None
            assert not native.available()
    finally:
        native.logger.removeHandler(caplog.handler)
    assert len(caplog.records) == 1 and "PIL" in caplog.records[0].getMessage()
    assert os.listdir(tmp_path) == []  # no half-written library left behind


@pytest.mark.parametrize("name", ["rgb", "gray", "rgba", "palette"])
def test_read_png_rgb_equals_pil_and_lvt_tpu(pngs, name):
    path = str(pngs / f"{name}.png")
    got = native.read_png_rgb(path)
    want = np.asarray(Image.open(path).convert("RGB"))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnative.read_png_rgb(path))


def test_corrupt_png_returns_none(pngs):
    assert native.read_png_rgb(str(pngs / "corrupt.png")) is None
    assert native.read_png_rgb(str(pngs / "missing.png")) is None


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_load_npy_sequence_equals_lvt_tpu(tmp_path, dtype):
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 512, (5, 4, 16, 16)).astype(dtype)
    paths = []
    for i, f in enumerate(frames):
        paths.append(str(tmp_path / f"{i}.npy"))
        np.save(paths[-1], f)
    got = native.load_npy_sequence_i32(paths, (4, 16, 16))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, frames.astype(np.int32))
    np.testing.assert_array_equal(got, jnative.load_npy_sequence_i32(paths, (4, 16, 16)))
    np.save(tmp_path / "float.npy", frames[0].astype(np.float32))
    assert native.load_npy_sequence_i32([str(tmp_path / "float.npy")], (4, 16, 16)) is None


@pytest.mark.parametrize("load_images", [False, True])
def test_bair_walkers_on_converted_records_equal_lvt_tpus(bair_root, load_images):
    for phase, n_videos in (("train", 2), ("test", 1)):
        got = tbair.load_bair(bair_root, phase, load_images)  # writes the path cache
        want = jbair.load_bair(bair_root, phase, load_images)  # reads it
        assert got == want
        assert len(got) == n_videos * (30 if load_images else 1)
        if not load_images:
            assert all(len(d["image_names"]) == 30 for d in got)


def _mapper_pair(is_vt=False, n_frames=4):
    cfgs = []
    for get in (get_cfg, jax_get_cfg):
        cfg = get()
        cfg.INPUT.FORMAT = "RGB"  # the VQ-VAE configs' format: the native decoder's
        if is_vt:
            cfg.MODEL.META_ARCHITECTURE = "VideoTransformerModel"
        cfg.INPUT.N_FRAMES_PER_VIDEO_TEST = n_frames
        cfgs.append(cfg)
    return DatasetMapper(cfgs[0], is_train=False), JaxMapper(cfgs[1], is_train=False)


def test_mapper_reads_frames_natively_as_lvt_tpu(bair_root, monkeypatch):
    calls = []
    read = native.read_png_rgb
    monkeypatch.setattr(tmapper.native, "read_png_rgb",
                        lambda p: calls.append(p) or read(p))
    tm, jm = _mapper_pair(n_frames=4)
    for video in tbair.load_bair(bair_root, "train", False):
        got, want = tm(dict(video)), jm(dict(video))
        assert got["image_sequence"].dtype == np.float32
        np.testing.assert_array_equal(got["image_sequence"], want["image_sequence"])
    for image in tbair.load_bair(bair_root, "test", True)[:3]:
        np.testing.assert_array_equal(tm(dict(image))["image"], jm(dict(image))["image"])
    assert len(calls) == 2 * 4 + 3  # every frame through the native decoder


def test_mapper_reads_latents_natively_as_lvt_tpu(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    root = tmp_path / "video_0"
    root.mkdir()
    for f in range(6):
        np.save(root / f"{f}.npy", rng.integers(0, 512, (4, 5, 6)).astype(np.int64))
    calls = []
    load = native.load_npy_sequence_i32
    monkeypatch.setattr(tmapper.native, "load_npy_sequence_i32",
                        lambda p, s: calls.append(p) or load(p, s))
    tm, jm = _mapper_pair(is_vt=True, n_frames=6)
    d = {"video_root": str(root), "latent_names": [f"{f}.npy" for f in range(6)],
         "video_idx": 0}
    got, want = tm(dict(d)), jm(dict(d))
    assert got["video"].dtype == np.int32 and got["video"].shape == (4, 6, 5, 6)
    np.testing.assert_array_equal(got["video"], want["video"])
    assert len(calls) == 1


def test_convert_kinetics_device_path_matches_lvt_tpus(tmp_path, monkeypatch):
    tck, jck = _script("convert_kinetics_torch"), _script("convert_kinetics")
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (3, 240, 320, 3), dtype=np.uint8)

    def fake_ffmpeg(cmd, shell=None, stderr=None):  # "extracts" into the save dir
        save_dir = os.path.dirname(cmd.split('"')[3])
        for i, f in enumerate(frames):
            Image.fromarray(f).save(os.path.join(save_dir, f"{i + 1}.png"))
        return b""

    monkeypatch.setattr(tck.subprocess, "check_output", fake_ffmpeg)
    video = tmp_path / "archery" / "vid.mp4"
    video.parent.mkdir()
    video.write_bytes(b"")
    outs = {}
    for name, mod, kw in (("torch", tck, {"device": "cpu"}), ("jax", jck, {})):
        out = tmp_path / f"out_{name}"
        assert mod.process_video(str(video), str(out), 64, preprocess="device", **kw) == 3
        outs[name] = np.stack([np.asarray(Image.open(out / "archery" / "vid" / f"{i + 1}.png"))
                               for i in range(3)]).astype(np.int32)
    assert outs["torch"].shape == (3, 64, 64, 3)
    assert np.abs(outs["torch"] - outs["jax"]).max() <= 1
