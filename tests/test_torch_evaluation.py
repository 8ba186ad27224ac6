"""The port's evaluation held to lvt_tpu's on the CPU, on the tiny
geometries of tests/test_evaluation.py, weights carried across with
from_jax_vqvae and from_jax_vt:

* utils/comm.py's world-of-one synchronize, all_gather and gather;
* the evaluator protocol (DatasetEvaluators, inference_on_dataset,
  _uncollate), testing.py and the two metrics on the same numpy inputs:
  equal to float64 rounding;
* the stage-1 -> stage-2 bridge: both packages' run_test (MSEEvaluator +
  CodesExtractor) on one PNG tree, MSE within 1e-5 relative, the latents'
  file lists identical and the arrays equal but at float64-verified near-ties
  (tests/test_torch_vqvae.py: within 8 fp32 ulps, at most 1 per 1000);
  then each package's bits/dim read from the latents that the other package
  wrote, within 1e-5 (fp32 logits of the same weights, summed in other
  orders; ~1e-6 per logit);
* build_test_loader: the same videos in the same order, with and without
  TEST.N_SAMPLES.
"""

import logging
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import lvt_tpu.evaluation as jev
import lvt_tpu.utils.comm as jcomm
import lvt_tpu_torch.evaluation as tev
import lvt_tpu_torch.utils.comm as tcomm
from lvt_tpu.config import get_cfg as jax_get_cfg
from lvt_tpu.data.build import build_test_loader as jax_build_test_loader
from lvt_tpu.data.catalog import DatasetCatalog as JaxCatalog
from lvt_tpu.data.datasets.latents import get_latent_video_paths as jax_latent_paths
from lvt_tpu.engine.defaults import run_test as jax_run_test
from lvt_tpu.models.vqvae import VQVAE as JaxVQVAE
from lvt_tpu.models.vt import VideoTransformer as JaxVT
from lvt_tpu.utils.image import get_video_paths as jax_video_paths
from lvt_tpu_torch.checkpoint import from_jax_vqvae, from_jax_vt
from lvt_tpu_torch.config import get_cfg
from lvt_tpu_torch.data.build import build_test_loader
from lvt_tpu_torch.data.catalog import DatasetCatalog
from lvt_tpu_torch.data.datasets.latents import get_latent_video_paths
from lvt_tpu_torch.engine.defaults import run_test
from lvt_tpu_torch.models.vqvae import VQVAE
from lvt_tpu_torch.models.vt import VideoTransformer
from lvt_tpu_torch.utils.image import get_video_paths
from test_torch_vqvae import assert_indices_match

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def register(name, jax_fn, port_fn):
    """Register ``name`` in both packages' catalogs (replacing an earlier one)."""
    for catalog, fn in ((JaxCatalog, jax_fn), (DatasetCatalog, port_fn)):
        catalog._REGISTERED.pop(name, None)
        catalog.register(name, fn)


def make_video_tree(root, n_videos=2, n_frames=8, size=32, seed=0):
    rng = np.random.default_rng(seed)
    for v in range(n_videos):
        d = os.path.join(root, f"video_{v}")
        os.makedirs(d, exist_ok=True)
        for f in range(n_frames):
            arr = rng.integers(0, 255, size=(size, size, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"{f}.png"))


def vq_cfg(get, out_dir):
    """tests/test_evaluation.py's tiny PR-DVQVAE2 (NF 16, 8 frames)."""
    cfg = get()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "vqvae", "PR-DVQVAE2.yaml"))
    for net in (cfg.MODEL.ENCODER, cfg.MODEL.GENERATOR):
        net.NF, net.RES_CHANNELS, net.N_LAYERS = 16, 8, 1
    cfg.MODEL.GENERATOR.IN_CHANNELS = 16
    cfg.MODEL.CODEBOOK.DIM = 16
    cfg.INPUT.N_FRAMES_PER_VIDEO_TEST = 8
    cfg.DATALOADER.NUM_WORKERS = 0
    cfg.OUTPUT_DIR = out_dir
    return cfg


def vt_cfg(get, out_dir, dataset, evaluators="BitsEvaluator"):
    """tests/test_evaluation.py's tiny VT (d 32, 2 + 2 layers, nv 512)."""
    cfg = get()
    cfg.MODEL.META_ARCHITECTURE = "VideoTransformerModel"
    cfg.MODEL.AUTOREGRESSIVE.NAME = "VideoTransformer"
    v = cfg.MODEL.AUTOREGRESSIVE.VT
    v.NC, v.NV = 4, 512
    v.KERNEL, v.STRIDE = (3, 1, 1), (8, 1, 1)
    v.D, v.DA, v.DE = 32, 16, 16
    v.BLOCKS_E = ((1, 8, 8),) * 2
    v.N_HEAD_E = (2, 2)
    v.BLOCKS_D = ((1, 8, 8),) * 2
    v.N_HEAD_D = (2, 2)
    v.N_PRIME = 1
    v.SHARE_P = False
    cfg.INPUT.SCALE_TO_ZEROONE = False
    cfg.INPUT.N_FRAMES_PER_VIDEO_TEST = 8
    cfg.DATASETS.TEST = (dataset,)
    cfg.TEST.EVALUATORS = evaluators
    cfg.DATALOADER.NUM_WORKERS = 0
    cfg.OUTPUT_DIR = out_dir
    return cfg


# --------------------------------------------------------------------------
# comm, the protocol, testing.py, the metrics
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["synchronize", "all_gather", "gather", "world"])
def test_comm_world_of_one_matches_lvt_tpu(name):
    data = {"mse": 1.5, "feats": [np.arange(3)]}
    if name == "synchronize":
        assert tcomm.synchronize() is None and jcomm.synchronize() is None
    elif name == "world":
        assert (tcomm.get_world_size(), tcomm.get_rank(), tcomm.is_main_process()) == \
            (jcomm.get_world_size(), jcomm.get_rank(), jcomm.is_main_process()) == (1, 0, True)
    else:
        got, want = getattr(tcomm, name)(data), getattr(jcomm, name)(data)
        assert len(got) == len(want) == 1 and got[0] is data and want[0] is data


class _Recorder(tev.DatasetEvaluator):
    def __init__(self, key):
        self.key, self.seen = key, []

    def reset(self):
        self.seen = []

    def process(self, inputs, outputs):
        self.seen.append((inputs, outputs))

    def evaluate(self):
        return {self.key: {"n": len(self.seen)}}


def test_evaluator_protocol_matches_lvt_tpu():
    rng = np.random.default_rng(0)
    batches = [{"video": rng.integers(0, 8, (2, 2, 4, 3, 3)), "video_idx": [2 * i, 2 * i + 1]}
               for i in range(3)]

    def infer(batch):
        return [{"s": int(v.sum())} for v in batch["video"]]

    results = []
    for pkg in (jev, tev):
        a, b = _Recorder("a"), _Recorder("b")
        both = pkg.DatasetEvaluators([a, b])
        r = pkg.inference_on_dataset(infer, batches, both)
        assert [len(x[0]) for x in a.seen] == [2, 2, 2]
        results.append((r, [(i, o) for x in a.seen for i, o in zip(*x)]))
        with pytest.raises(AssertionError, match="Duplicate"):
            pkg.DatasetEvaluators([_Recorder("a"), _Recorder("a")]).evaluate()
    (rj, sj), (rt, st) = results
    assert rj == rt == {"a": {"n": 3}, "b": {"n": 3}}
    assert len(sj) == len(st) == 6
    for (ij, oj), (it, ot) in zip(sj, st):
        assert oj == ot and ij["video_idx"] == it["video_idx"]
        np.testing.assert_array_equal(ij["video"], it["video"])


def test_testing_module_matches_lvt_tpu(caplog, monkeypatch):
    results = {"reconstruction": {"MSE": 0.55, "x-y": 2.0}, "likelihood": {"bits_per_dim": 3.25}}
    assert tev.flatten_results_dict({"a": {"b": 1, "c": {"d": 2}}, "e": 3}) == \
        jev.flatten_results_dict({"a": {"b": 1, "c": {"d": 2}}, "e": 3}) == \
        {"a/b": 1, "a/c/d": 2, "e": 3}
    logs = []
    for pkg in (jev, tev):
        # the capture hangs on the module's own logger, which stops there:
        # an earlier setup_logger (propagate off on the package's logger)
        # cannot hide its records, nor the root hand them over twice
        logger = logging.getLogger(pkg.print_csv_format.__module__)
        monkeypatch.setattr(logger, "propagate", False)
        logger.addHandler(caplog.handler)
        caplog.clear()
        try:
            with caplog.at_level("INFO", logger=logger.name):
                pkg.print_csv_format(results)
        finally:
            logger.removeHandler(caplog.handler)
        logs.append([r.getMessage() for r in caplog.records])
    assert logs[0] == logs[1] and "copypaste: 0.5500" in logs[1]
    for get, pkg in ((jax_get_cfg, jev), (get_cfg, tev)):
        cfg = get()
        assert pkg.verify_results(cfg, results)  # nothing expected
        cfg.TEST.EXPECTED_RESULTS = [["reconstruction", "MSE", 0.5, 0.1]]
        assert pkg.verify_results(cfg, results)
        cfg.TEST.EXPECTED_RESULTS = [["reconstruction", "MSE", 0.9, 0.1]]
        with pytest.raises(SystemExit) as exc:
            pkg.verify_results(cfg, results)
        assert exc.value.code == 1


def test_metrics_match_lvt_tpu():
    """MSEEvaluator and BitsEvaluator on the same numpy inputs: the same
    float64 host reductions, so equal."""
    rng = np.random.default_rng(1)
    T, H, W, nc, nv = 4, 3, 3, 2, 16
    inputs = [{"image_sequence": rng.random((T, 8, 8, 3)).astype(np.float32),
               "video": rng.integers(0, nv, (nc, T, H, W)).astype(np.int32)} for _ in range(3)]
    outputs = [{"reconstruction": rng.random((T, 8, 8, 3)).astype(np.float32),
                "logits": rng.normal(0, 3, (T, H, W, nc, nv)).astype(np.float32),
                "ignore_t": np.arange(T) < 1} for _ in range(3)]
    got, want = {}, {}
    for pkg, out in ((jev, want), (tev, got)):
        for cls in (pkg.MSEEvaluator, pkg.BitsEvaluator):
            ev = cls("toy", distributed=True)
            ev.process(inputs[:2], outputs[:2])
            ev.process(inputs[2:], outputs[2:])
            out.update(ev.evaluate())
            ev.reset()  # back to nothing seen
            assert list(ev.evaluate().values())[0] in ({"MSE": 0.0}, {"bits_per_dim": 0.0})
    assert got == want
    assert set(got) == {"reconstruction", "likelihood"}
    assert 0 < got["likelihood"]["bits_per_dim"] and np.isfinite(got["reconstruction"]["MSE"])


def test_codes_extractor_layout_matches_lvt_tpu(tmp_path):
    """Kinetics-style inputs (with a class) and BAIR-style ones land in the
    same files in both packages."""
    rng = np.random.default_rng(2)
    inputs = [{"video_idx": 3, "class": 5}, {"video_idx": 4}]
    outputs = [{"latent": rng.integers(0, 512, (4, 2, 3, 3)).astype(np.int32)},
               {"latent": rng.integers(0, 512, (4, 3, 3)).astype(np.int32)}]
    trees = []
    for pkg, sub in ((jev, "jax"), (tev, "port")):
        root = str(tmp_path / sub)
        ev = pkg.CodesExtractor("ds", output_dir=root)
        ev.process(inputs[:1], outputs[:1])
        ev.process(inputs[1:], outputs[1:])
        assert ev.evaluate() == {"latents": {}}
        trees.append(sorted(os.path.relpath(os.path.join(d, f), root)
                            for d, _, fs in os.walk(root) for f in fs))
    assert trees[0] == trees[1] and len(trees[0]) == 8
    for rel in trees[0]:
        a, b = np.load(str(tmp_path / "jax" / rel)), np.load(str(tmp_path / "port" / rel))
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert os.path.join("ds", "video_4", "0.npy") in trees[0]
    assert any(rel.startswith(os.path.join("ds", "")) and rel.count(os.sep) == 3
               for rel in trees[0])  # ds/<class name>/video_3/<f>.npy


# --------------------------------------------------------------------------
# The stage bridge
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bridge(tmp_path_factory):
    """Stage 1 in both packages on one PNG tree, on the same weights."""
    tmp = tmp_path_factory.mktemp("bridge")
    video_root = str(tmp / "vids")
    make_video_tree(video_root)
    register("toy_videos_seq_bridge", lambda: jax_video_paths(video_root, use_cache=False),
             lambda: get_video_paths(video_root, use_cache=False))
    out = {}
    for name, get in (("jax", jax_get_cfg), ("port", get_cfg)):
        cfg = vq_cfg(get, str(tmp / f"{name}_out"))
        cfg.DATASETS.TEST = ("toy_videos_seq_bridge",)
        cfg.TEST.EVALUATORS = "MSEEvaluator,CodesExtractor"
        out[name] = cfg
    jm = JaxVQVAE(out["jax"])
    jp, js = jm.init(jax.random.key(0))
    res_j = jax_run_test(out["jax"], jm, jp, js)
    tp, ts = from_jax_vqvae(_np(jp), _np(js))
    res_t = run_test(out["port"], VQVAE(out["port"]), tp, ts)
    roots = {k: os.path.join(c.OUTPUT_DIR, "inference", "toy_videos_seq_bridge")
             for k, c in out.items()}
    return dict(tmp=tmp, video_root=video_root, jm=jm, jp=jp, js=js, res_j=res_j, res_t=res_t,
                roots=roots)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_stage1_mse_and_latents_match_lvt_tpu(bridge):
    mj = bridge["res_j"]["reconstruction"]["MSE"]
    mt = bridge["res_t"]["reconstruction"]["MSE"]
    assert np.isfinite(mt) and abs(mt - mj) <= 1e-5 * abs(mj), (mt, mj)
    assert set(bridge["res_t"]) == {"reconstruction", "latents"}
    roots = bridge["roots"]
    files = _files(roots["port"])
    assert files == _files(roots["jax"])
    assert len(files) == 2 * 8 and os.path.join("video_1", "7.npy") in files
    jm, jp, js = bridge["jm"], bridge["jp"], bridge["js"]
    for v in range(2):
        want = np.stack([np.load(os.path.join(roots["jax"], f"video_{v}", f"{f}.npy"))
                         for f in range(8)])
        got = np.stack([np.load(os.path.join(roots["port"], f"video_{v}", f"{f}.npy"))
                        for f in range(8)])
        assert got.shape == want.shape == (8, 4, 8, 8) and got.dtype == want.dtype == np.int32
        frames = np.stack([np.asarray(Image.open(os.path.join(
            bridge["video_root"], f"video_{v}", f"{f}.png")), np.float32) for f in range(8)])
        x = np.asarray(jm.normalize(frames))
        assert_indices_match(jm, jp, js, x, got.transpose(0, 2, 3, 1), want.transpose(0, 2, 3, 1))


def test_stage2_bits_per_dim_across_packages(bridge, tmp_path):
    """Each package's bits/dim over the latents that the other wrote."""
    roots = bridge["roots"]
    for who, root in roots.items():
        register(f"toy_latents_{who}", lambda r=root: jax_latent_paths(r, use_cache=False),
                 lambda r=root: get_latent_video_paths(r, use_cache=False))
    jcfg = vt_cfg(jax_get_cfg, str(tmp_path / "vt_jax"), "toy_latents_port")
    tcfg = vt_cfg(get_cfg, str(tmp_path / "vt_port"), "toy_latents_jax")
    jvt = JaxVT(jcfg, T=8, H=8, W=8)
    jparams, jstate = jvt.init(jax.random.key(1))
    tparams = {"netG": from_jax_vt(_np(jparams["netG"]))}
    tvt = VideoTransformer(tcfg, T=8, H=8, W=8)
    bj = jax_run_test(jcfg, jvt, jparams, jstate)["likelihood"]["bits_per_dim"]
    bt = run_test(tcfg, tvt, tparams, {})["likelihood"]["bits_per_dim"]
    assert 7.0 < bt < 11.0 and abs(bt - bj) <= 1e-5, (bt, bj)
    # and each on its own package's latents, through the same files
    tcfg.DATASETS.TEST = ("toy_latents_port",)
    bt_own = run_test(tcfg, tvt, tparams, {})["likelihood"]["bits_per_dim"]
    assert abs(bt_own - bj) <= 1e-5, (bt_own, bj)


@pytest.mark.parametrize("n_samples,workers", [(0, 0), (3, 2)])
def test_build_test_loader_order_matches_lvt_tpu(tmp_path, n_samples, workers):
    rng = np.random.default_rng(4)
    root = str(tmp_path / "lat")
    for v in range(5):
        d = os.path.join(root, f"video_{v}")
        os.makedirs(d)
        for f in range(4):
            np.save(os.path.join(d, f"{f}.npy"), rng.integers(0, 16, (2, 3, 3)).astype(np.int64))
    register("toy_loader_order", lambda: jax_latent_paths(root, use_cache=False),
             lambda: get_latent_video_paths(root, use_cache=False))
    seen = []
    for get, build in ((jax_get_cfg, jax_build_test_loader), (get_cfg, build_test_loader)):
        cfg = vt_cfg(get, str(tmp_path / "out"), "toy_loader_order")
        cfg.INPUT.N_FRAMES_PER_VIDEO_TEST = 4
        cfg.TEST.N_SAMPLES = n_samples
        cfg.DATALOADER.NUM_WORKERS = workers
        loader = build(cfg, "toy_loader_order")
        batches = list(loader)
        assert len(loader) == len(batches) == (n_samples or 5)
        seen.append([(b["video_idx"], b["video"]) for b in batches])
    for (ij, vj), (it, vt) in zip(*seen):
        assert list(ij) == list(it) and len(it) == 1
        assert vj.dtype == vt.dtype == np.int32 and np.array_equal(vj, vt)
    if n_samples == 0:
        assert [b[0][0] for b in seen[1]] == list(range(5))
