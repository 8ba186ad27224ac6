"""The port's counterparts of the last reference tools, held on the CPU
against lvt_tpu's tools on the same seeded inputs:

* tools/quality_int8_torch.py: its JSON keys (read from the reference's
  source) on a tiny run of the whole tool; its teacher-forced metrics on
  lvt_tpu's weights carried across with from_jax_vt, against lvt_tpu's
  logits under the reference's reductions (fp32: bits/dim within 2e-5
  relative; the int8 cache's relative errors within 1e-3 of lvt_tpu's,
  the two packages' fp32 activations, quantized to int8, differing by fp32
  noise; 3e-5 measured);
* tools/convert_i3d_torch.py: its .npz array for array equal to
  tools/convert_i3d.py's on the checkpoints tests/test_convert_i3d.py
  fabricates (both source formats, gammas folded), loaded by load_i3d_npz;
* tools/trace_summary_torch.py on a chrome trace of the CPU profiler and on
  device lanes written into it, self-time by containment;
* the profiler hook (engine/hooks.py TorchProfiler): a readable trace, and a
  dangling one stopped in after_train;
* tools/mfu_torch.py: the analytic FLOPs equal to tools/mfu.py's function,
  both modes' keys, the int4 cache's bytes, the --probe-dot refusal;
* tools/soak_train_torch.py at a tiny size in subprocesses: killed,
  resumed at the checkpoint, its checks and keys;
* each tool's CLI asks for the card unless --device cpu.
"""

import ast
import fnmatch
import gzip
import importlib.util
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_convert_i3d import _fake_tf_dump, _fake_torch_state
from test_convert_i3d import conv as ref_convert_i3d
from test_torch_vt import _cfg as vt_cfg
from torch_dp_worker import one_thread_children

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import convert_i3d_torch  # noqa: E402
import mfu_torch  # noqa: E402
import quality_int8_torch as qi  # noqa: E402
import soak_train_torch  # noqa: E402
import trace_summary_torch as ts  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

_V = "MODEL.AUTOREGRESSIVE.VT."
# DSFVT.yaml narrowed: 16 frames of 16 x 16, d = 16, one layer a stack
TINY_VT = [_V + "NC", "2", _V + "NV", "8", _V + "D", "16", _V + "DA", "8", _V + "DE", "8",
           _V + "BLOCKS_E", "((1,16,16),)", _V + "N_HEAD_E", "(2,)",
           _V + "BLOCKS_D", "((1,16,16),)", _V + "N_HEAD_D", "(2,)"]


def _source_keys(rel, func, names=("out",), dumps=True):
    """The JSON keys of a reference tool, read from its source: inside
    function ``func``, the keys of the dict literals passed to json.dumps
    (unless ``dumps`` is False) or assigned to one of ``names``, and the
    string keys assigned into those names. An f-string key becomes a
    pattern, its fields ``*``."""
    with open(os.path.join(ROOT, rel)) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    dicts, keys = [], set()
    for node in ast.walk(fn):
        if (dumps and isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and isinstance(node.args[0], ast.Dict)):
            dicts.append(node.args[0])
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name) and tgt.id in names and isinstance(node.value, ast.Dict):
                dicts.append(node.value)
            if (isinstance(tgt, ast.Subscript) and isinstance(tgt.value, ast.Name)
                    and tgt.value.id in names and isinstance(tgt.slice, ast.Constant)):
                keys.add(tgt.slice.value)
    for d in dicts:
        for k in d.keys:
            if isinstance(k, ast.Constant):
                keys.add(k.value)
            elif isinstance(k, ast.JoinedStr):
                keys.add("".join(v.value if isinstance(v, ast.Constant) else "*"
                                 for v in k.values))
    assert keys, (rel, func)
    return keys


def _has_keys(res, patterns):
    missing = [p for p in patterns if not fnmatch.filter(res, p)]
    assert not missing, missing


# --------------------------------------------------------------------------
# tools/quality_int8_torch.py
# --------------------------------------------------------------------------

QI_OPTS = [_V + "NC", "4", _V + "NV", "8", _V + "D", "16", _V + "DA", "8", _V + "DE", "8",
           _V + "STRIDE", "(8,1,1)", _V + "KERNEL", "(3,1,1)",
           _V + "BLOCKS_E", "((1,8,8),)", _V + "N_HEAD_E", "(2,)",
           _V + "BLOCKS_D", "((1,8,8),)", _V + "N_HEAD_D", "(2,)",
           "TEST.VT_SAMPLER.N_PRIME", "2"]


def test_quality_int8_keys_and_a_tiny_run(monkeypatch):
    """The whole tool on the CPU (a latent video of 8 x 8 x 8, 4 channels for
    the FVD_stub's pseudo-RGB): the reference's keys, and numbers that hang
    together."""
    monkeypatch.setattr(qi, "THW", (8, 8, 8))
    res = qi.main(["--device", "cpu", "--iters", "2"] + QI_OPTS)
    _has_keys(res, _source_keys("tools/quality_int8.py", "main", ("out", "fvd")))
    assert res["backend"] == "cpu" and res["kv"] == "int8" and res["train_iters"] == 2
    assert res["greedy_total_steps"] == 8 * 64 * 4  # 8 slices of 8 x 8 pixels, 4 channels
    assert 0 <= res["greedy_first_divergence_min"] <= res["greedy_total_steps"]
    assert 0.5 < res["greedy_code_agreement"] <= 1.0
    # the cached native teacher pass is the anchor's function up to bf16 noise
    np.testing.assert_allclose(res["tf_bits_per_dim_native"], res["tf_bits_per_dim_xla_anchor"],
                               rtol=1e-2)
    assert 0 < res["tf_logit_rel_err_mean"] <= res["tf_logit_rel_err_p99"] \
        <= res["tf_logit_rel_err_max"]
    assert all(np.isfinite(res[k]) and res[k] >= 0 for k in res if k.startswith("fvd_stub"))


def test_quality_int8_int4_refused(monkeypatch):
    """--kv int4 runs the whole tool with the int4 cache: the reference's
    keys, the mode named, and the int4 cache's logit error above zero."""
    monkeypatch.setattr(qi, "THW", (8, 8, 8))
    res = qi.main(["--device", "cpu", "--kv", "int4", "--iters", "2"] + QI_OPTS)
    _has_keys(res, _source_keys("tools/quality_int8.py", "main", ("out", "fvd")))
    assert res["kv"] == "int4" and res["tf_logit_rel_err_max"] > 0
    assert 0.5 < res["greedy_code_agreement"] <= 1.0


def _jax_tf_metrics(ln, lq, lx, video, n_prime, nv):
    """tools/quality_int8.py's tf_metrics (local to its main): the same
    reductions, on lvt_tpu's logits."""
    T = video.shape[2]
    target = jnp.moveaxis(video, 1, -1)
    keep_b = (jnp.arange(T) >= n_prime).astype(jnp.float32)[None, :, None, None, None]
    err = jnp.max(jnp.abs(lq - ln), axis=-1)
    den = jnp.max(jnp.abs(ln), axis=-1) + 1e-6
    rel = err / den
    w = jnp.broadcast_to(keep_b, rel.shape)
    out = {"rel_mean": jnp.sum(rel * w) / jnp.sum(w), "rel_max": jnp.max(rel * w),
           "rel_p99": jnp.percentile(jnp.where(w > 0, rel, -1.0).reshape(-1), 99)}

    def bpd(lg):
        ce = (jax.nn.logsumexp(lg, axis=-1)
              - jnp.sum(lg * jax.nn.one_hot(target, nv), axis=-1))
        return jnp.sum(ce * keep_b) / jnp.sum(jnp.broadcast_to(keep_b, ce.shape)) / np.log(2.0)

    out.update(bpd_native=bpd(ln), bpd_quant=bpd(lq), bpd_xla=bpd(lx))
    return {k: float(v) for k, v in out.items()}


def test_quality_int8_teacher_forced_metrics_match_lvt_tpu():
    """lvt_tpu's weights in both packages (fp32, a DSFVT-like geometry of
    stride (4, 1, 1) on 8 x 4 x 4 latents, 2 videos, n_prime 2): the tool's
    tf_metrics on the port's cached and whole-slice logits against the
    reference's reductions on lvt_tpu's."""
    from lvt_tpu.models.vt import VideoTransformer as JaxVT
    from lvt_tpu_torch.checkpoint import from_jax_vt
    from lvt_tpu_torch.models.vt import VideoTransformer

    cfg = vt_cfg((4, 1, 1), (3, 1, 1), ((1, 4, 4),) * 2)
    jm = JaxVT(cfg, T=8, H=4, W=4)
    jp, _ = jm.init(jax.random.key(4))
    tm = VideoTransformer(cfg, T=8, H=4, W=4)
    tp = {"netG": from_jax_vt(jax.tree_util.tree_map(np.array, jp["netG"]))}
    video = np.random.default_rng(6).integers(0, 8, size=(2, 2, 8, 4, 4)).astype(np.int32)

    inc = jax.jit(lambda v, kvd: jm.logits_for_entire_video_incremental(
        jp, v, kv_cache_dtype=kvd, kv_seg_size=10 ** 6), static_argnums=(1,))
    jv = jnp.asarray(video)
    want = _jax_tf_metrics(inc(jv, "native"), inc(jv, "int8"), jm.logits_for_entire_video(jp, jv),
                           jv, 2, 8)
    tv = torch.from_numpy(video)
    got = qi.tf_metrics(tm.logits_for_entire_video_incremental(tp, tv),
                        tm.logits_for_entire_video_incremental(tp, tv, kv_cache_dtype="int8"),
                        tm.logits_for_entire_video(tp, tv), tv, 2)
    assert set(got) == set(want)
    for k in ("bpd_native", "bpd_quant", "bpd_xla"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, err_msg=k)
    for k in ("rel_mean", "rel_p99", "rel_max"):
        assert want[k] > 0, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)


# --------------------------------------------------------------------------
# tools/convert_i3d_torch.py
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def i3d_flat():
    """A full I3D tree in the file's layout ((t, h, w, in, out) weights),
    drawn by the port's init_i3d, with seeded batch-norm statistics."""
    from lvt_tpu_torch.evaluation.i3d import init_i3d

    rng = np.random.default_rng(8)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            elif k == "w":
                flat[prefix + k] = v.permute(2, 3, 4, 1, 0).numpy().copy()
            elif k in ("beta", "mean"):
                flat[prefix + k] = rng.normal(size=v.shape).astype(np.float32)
            elif k == "var":
                flat[prefix + k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            else:
                flat[prefix + k] = v.numpy().copy()

    walk(init_i3d(torch.Generator().manual_seed(3)), "")
    return flat


def _assert_same_npz(path, want):
    with np.load(path) as got:
        assert sorted(got.files) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_convert_i3d_tf_dump_equals_the_reference(i3d_flat, tmp_path):
    from lvt_tpu_torch.evaluation.i3d import i3d_apply, load_i3d_npz

    dump = _fake_tf_dump(i3d_flat)
    src = str(tmp_path / "i3d_tf_dump.npz")
    np.savez(src, **dump)
    out = str(tmp_path / "i3d.npz")
    convert_i3d_torch.main(["--src", src, "--out", out])
    _assert_same_npz(out, ref_convert_i3d.convert_tf_npz(dump))
    _assert_same_npz(out, i3d_flat)  # the tree it was fabricated from
    tree = load_i3d_npz(out)
    assert torch.equal(tree["Mixed_5b"]["Branch_2"]["Conv3d_0b_3x3"]["w"],
                       torch.from_numpy(i3d_flat["Mixed_5b/Branch_2/Conv3d_0b_3x3/w"])
                       .permute(4, 3, 0, 1, 2))
    logits = i3d_apply(tree, torch.zeros((1, 8, 32, 32, 3)))
    assert logits.shape == (1, 400) and bool(torch.isfinite(logits).all())


def test_convert_i3d_torch_state_equals_the_reference(i3d_flat, tmp_path):
    """A pytorch-i3d state dict with gammas in (0.5, 2): the fold's output
    array for array the reference's."""
    rng = np.random.default_rng(9)
    gammas = {k.rsplit("/", 1)[0]: rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
              for k, v in i3d_flat.items() if k.endswith("/beta")}
    state = _fake_torch_state(i3d_flat, gammas)
    src = str(tmp_path / "rgb_imagenet.pt")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()}, src)
    out = str(tmp_path / "i3d.npz")
    convert_i3d_torch.main(["--src", src, "--out", out])
    want = ref_convert_i3d.convert_torch(state)
    _assert_same_npz(out, want)
    bad = dict(want)
    del bad["Logits/b"]
    with pytest.raises(ValueError, match="missing"):
        convert_i3d_torch.validate(bad)


# --------------------------------------------------------------------------
# tools/trace_summary_torch.py and the profiler hook
# --------------------------------------------------------------------------

def _cpu_trace(path):
    from torch.profiler import ProfilerActivity, profile, record_function

    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            for _ in range(3):
                a = torch.tanh(a @ a)
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_summary_host_lanes_by_containment(tmp_path, capsys):
    events = _cpu_trace(str(tmp_path / "cpu.json"))
    agg, total = ts.summarize(events, "host")
    assert agg["outer"][1] == 1 and agg["aten::mm"][1] == 3 and agg["aten::tanh"][1] == 3
    outer = next(e for e in events if e.get("name") == "outer" and e.get("ph") == "X")
    inside = [e for e in events if e.get("ph") == "X" and e.get("tid") == outer["tid"]
              and e.get("pid") == outer["pid"] and e is not outer
              and outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]]
    children = [e for e in inside if not any(
        p is not e and p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]
        and p["dur"] > e["dur"] for p in inside)]
    np.testing.assert_allclose(agg["outer"][0], outer["dur"] - sum(e["dur"] for e in children),
                               rtol=1e-9, atol=1e-6)
    # the CLI prints the same, --like filters, --top cuts
    got, _ = ts.main([str(tmp_path / "cpu.json"), "--lanes", "host", "--like", "aten::", "--top",
                      "2"])
    assert set(got) == {k for k in agg if "aten::" in k}
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 1 + 2 + 1 and printed[-1].endswith("TOTAL (self, host lanes)")
    with pytest.raises(SystemExit, match="no device lanes"):
        ts.summarize(events, "device")


def test_trace_summary_device_lanes_newest_gz(tmp_path):
    """Kernel and annotation events on a "GPU 0" process, as torch.profiler
    writes them on the card, in a .json.gz that is the newest trace of its
    directory: the annotation keeps its own time, trailing indices merge."""
    events = _cpu_trace(str(tmp_path / "cpu.json"))
    events += [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "GPU 0"}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "step", "pid": 0, "tid": 7,
         "ts": 100.0, "dur": 30.0},
        {"ph": "X", "cat": "kernel", "name": "gemm", "pid": 0, "tid": 7, "ts": 100.0,
         "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "fill.3", "pid": 0, "tid": 7, "ts": 112.0,
         "dur": 8.0},
        {"ph": "X", "cat": "kernel", "name": "fill.4", "pid": 0, "tid": 8, "ts": 112.0,
         "dur": 2.0},
    ]
    d = tmp_path / "traces"
    d.mkdir()
    with gzip.open(d / "new.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    shutil.copy(tmp_path / "cpu.json", d / "old.json")
    os.utime(d / "old.json", (1, 1))
    agg, total = ts.main([str(d)])
    assert agg == {"step": [12.0, 1], "gemm": [10.0, 1], "fill": [10.0, 2]} and total == 32.0


def test_profiler_hook_writes_a_trace_and_stops_a_dangling_one(tmp_path, rng):
    from lvt_tpu_torch.engine import TorchProfiler, Trainer
    from test_torch_train import BATCH, H, T, W
    from test_torch_train import _cfg as train_cfg

    batches = [{"video": rng.integers(0, 8, size=(BATCH, 2, T, H, W)).astype(np.int32)}
               for _ in range(3)]
    tr = Trainer(train_cfg(), batches, device="cpu")
    hook = TorchProfiler(lambda trainer: trainer.iter == 1, str(tmp_path / "a"))
    tr.register_hooks([hook])
    tr.train(0, 3)
    assert os.listdir(tmp_path / "a") == ["torch_trace_iter1.json"] and hook._prof is None
    agg, _ = ts.summarize(ts.load_events(str(tmp_path / "a")), "host")
    assert agg["aten::mm"][1] > 0 and "Optimizer.step#Adam.step" in agg

    def broken():  # the loader fails in the profiled iteration: after_step never runs
        yield batches[0]
        raise RuntimeError("the loader broke")

    tr = Trainer(train_cfg(), broken(), device="cpu")
    hook = TorchProfiler(lambda trainer: trainer.iter == 1, str(tmp_path / "b"))
    tr.register_hooks([hook])
    with pytest.raises(RuntimeError, match="loader broke"):
        tr.train(0, 3)
    assert os.listdir(tmp_path / "b") == ["torch_trace_iter1.json"] and hook._prof is None
    ts.load_events(str(tmp_path / "b"))
    with torch.profiler.profile() as prof:  # the profiler starts again
        torch.ones(2).sum()
    assert prof.events()


# --------------------------------------------------------------------------
# tools/mfu_torch.py
# --------------------------------------------------------------------------

def _reference_mfu():
    spec = importlib.util.spec_from_file_location("reference_mfu",
                                                  os.path.join(ROOT, "tools", "mfu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("config,batch", [("DSFVT", 64), ("DSSVT", 64), ("DSTSVT", 64),
                                          ("KDSFVT", 32)])
def test_mfu_analytic_flops_equal_the_reference(config, batch):
    from lvt_tpu.config import get_cfg as jax_get_cfg
    from lvt_tpu.models.vt import VideoTransformer as JaxVT
    from lvt_tpu_torch.config import get_cfg
    from lvt_tpu_torch.models.vt import VideoTransformer

    path = os.path.join(ROOT, "configs", "vt", f"{config}.yaml")
    jcfg, tcfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_file(path)
    tcfg.merge_from_file(path)
    T = tcfg.INPUT.N_FRAMES_PER_VIDEO_TRAIN
    want = _reference_mfu()._analytic_vt_train_flops(JaxVT(jcfg, T=T, H=16, W=16), batch, T=T)
    got = mfu_torch._analytic_vt_train_flops(VideoTransformer(tcfg, T=T, H=16, W=16), batch, T=T)
    assert got == want > 1e12


def test_mfu_train_step_keys_and_policies():
    ref = _source_keys("tools/mfu.py", "main")
    for argv, want in ((["--remat-policy", "qkv", "TPU.FUSED_LAYER", "False"], (False, "qkv")),
                       (["--fused"], (True, ""))):
        res = mfu_torch.main(["--device", "cpu", "--batch", "2", "--steps", "1"] + argv +
                             TINY_VT + ["SOLVER.OPT_STATE_DTYPE", "bfloat16"])
        _has_keys(res, ref)
        assert res["flops_source"].startswith("analytic") and res["gflops_per_step"] > 0
        assert res["opt_state_dtype"] == "bfloat16" and res["s_per_it"] > 0
        assert res["peak_tflops"] == 989.0 and res["gbytes_per_step"] is None
        assert (res["fused_layer"], res["remat_policy"]) == want


def test_mfu_sample_roofline_keys_and_refusals(tmp_path):
    res = mfu_torch.main(["--device", "cpu", "--sample", "--kv", "native", "--batch", "2",
                          "--measure", "--iters", "1", "--trace", str(tmp_path)] + TINY_VT)
    # dumps=False: the other json.dumps there prints --probe-dot's keys (refused)
    _has_keys(res, _source_keys("tools/mfu.py", "_sample_roofline", dumps=False))
    assert set(res["bytes_per_step_mb"]) == _source_keys("tools/mfu.py", "_sample_roofline",
                                                         ("terms",), dumps=False)
    assert res["pixel_steps"] == 11 * 256 and res["blk_run"] == 256
    assert res["mean_cache_rows"] == 128.5 and res["bytes_per_step_mb"]["cache_concat_copies"] == 0
    assert res["measured_step_ms"] > 0
    assert os.listdir(tmp_path) == ["mfu_torch_sample_trace.json"]
    with pytest.raises(NotImplementedError):
        mfu_torch.main(["--device", "cpu", "--sample", "--probe-dot"] + TINY_VT)
    # the int4 cache: half a byte an element, as tools/mfu.py counts it, with
    # the quantized cache's scales, beside a measured int4 rollout
    # (the byte counts at batch 1024, analytic only: the JSON rounds them to 0.01 MB)
    terms = {k: mfu_torch.main(["--device", "cpu", "--sample", "--kv", k, "--batch", "1024"]
                               + TINY_VT)["bytes_per_step_mb"] for k in ("int8", "int4")}
    assert terms["int4"]["kv_cache_reads"] * 2 == pytest.approx(terms["int8"]["kv_cache_reads"],
                                                               abs=0.011)
    assert terms["int4"]["kv_scale_reads"] == terms["int8"]["kv_scale_reads"] > 0
    res = mfu_torch.main(["--device", "cpu", "--sample", "--kv", "int4", "--batch", "2",
                          "--measure", "--iters", "1"] + TINY_VT)
    assert res["kv"] == "int4" and res["measured_step_ms"] > 0


# --------------------------------------------------------------------------
# tools/soak_train_torch.py
# --------------------------------------------------------------------------

def test_soak_train_kills_resumes_and_checks(tmp_path):
    """Two child processes at a tiny size: the first SIGKILLed past its
    second checkpoint, the second resumed there; the tool's checks hold and
    it prints the reference's keys."""
    argv = ["--device", "cpu", "--workdir", str(tmp_path), "--iters", "120", "--ckpt-period",
            "4", "--kill-after-ckpts", "2", "--kill-delay", "0", "--poll", "0.05", "--batch",
            "2", "--eval-period", "60", "--videos", "32", "--max-to-keep", "2",
            "--writer-period", "2"] + TINY_VT + ["DATALOADER.NUM_WORKERS", "0"]
    with one_thread_children():
        res = soak_train_torch.main(argv)
    _has_keys(res, _source_keys("tools/soak_train.py", "orchestrate"))
    assert 8 <= res["killed_after_ckpt"] < 120 and res["killed_after_ckpt"] % 4 == 0
    assert res["resume_start_iter"] == res["killed_after_ckpt"]
    assert res["final_iter"] == 119 and res["checkpoints_kept"] == [116, 120]
    assert res["eval_rows"] == 2  # iterations 60 and the end


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------

def test_tools_need_the_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (qi, mfu_torch, soak_train_torch):
        with pytest.raises(SystemExit, match="CUDA"):
            tool.main([])

