"""The port's package boundary: its copied config/utils/engine/data/
evaluation modules equal their lvt_tpu originals (events.py apart from its
one device-memory probe), all 7 configs merge to the same tree in both packages, and
lvt_tpu_torch (with its entry points) imports neither JAX nor lvt_tpu."""

import ast
import glob
import os
import subprocess
import sys
import tokenize

import pytest
import torch

from lvt_tpu.config import get_cfg as jax_get_cfg
from lvt_tpu_torch.config import get_cfg as torch_get_cfg

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))
COPIES = ["config/__init__.py", "config/config.py", "config/defaults.py",
          "utils/registry.py", "utils/image.py", "utils/strings.py", "utils/labels.py",
          "utils/logger.py", "engine/train_loop.py", "data/catalog.py",
          "data/datasets/latents.py", "data/samplers.py", "data/datasets/bair.py",
          "data/datasets/kinetics.py", "data/datasets/builtin.py", "evaluation/testing.py",
          "evaluation/metrics.py", "evaluation/codes_extractor.py", "utils/pbar.py",
          "utils/serialize.py"]


def test_all_seven_configs_found():
    assert len(CONFIGS) == 7


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, ROOT))
def test_merged_configs_equal(path):
    a, b = jax_get_cfg(), torch_get_cfg()
    a.merge_from_file(path)
    b.merge_from_file(path)
    assert a == b
    assert a.dump() == b.dump()


def _code_tokens(path):
    """The file's Python tokens, comments and layout aside (the port's copies
    drop the JAX package's TPU measurements from their comments)."""
    skip = (tokenize.COMMENT, tokenize.NL, tokenize.NEWLINE, tokenize.INDENT,
            tokenize.DEDENT, tokenize.ENCODING)
    with open(path, "rb") as f:
        return [(t.type, t.string) for t in tokenize.tokenize(f.readline)
                if t.type not in skip]


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_equals_original(rel):
    assert _code_tokens(os.path.join(ROOT, "lvt_tpu_torch", rel)) == \
        _code_tokens(os.path.join(ROOT, "lvt_tpu", rel))


def test_copied_events_equals_original_but_its_memory_probe():
    """utils/events.py: every statement equal to lvt_tpu's but
    _device_memory_mb, which reads torch.cuda instead of jax."""
    def body(rel):
        with open(os.path.join(ROOT, rel)) as f:
            tree = ast.parse(f.read())
        return {getattr(n, "name", f"#{i}"): ast.dump(n) for i, n in enumerate(tree.body)}

    port, orig = body("lvt_tpu_torch/utils/events.py"), body("lvt_tpu/utils/events.py")
    assert set(port) == set(orig)
    differ = sorted(k for k in orig if port[k] != orig[k])
    assert differ == ["_device_memory_mb"]


def test_port_imports_neither_jax_nor_lvt_tpu():
    """Every module of lvt_tpu_torch (the .pth converter included), the
    generation, training and conversion scripts, the e2e, pipeline, bench,
    probe and timing tools and chip_smoke.py, imported in a fresh interpreter, pull in no jax and no
    lvt_tpu."""
    code = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {scripts!r})
sys.path.insert(0, {tools!r})
import lvt_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lvt_tpu_torch.__path__, "lvt_tpu_torch.")]
assert "lvt_tpu_torch.checkpoint.torch_convert" in names, names
for name in names + ["generate_videos_torch", "train_net_torch", "probe_decode_kernel_torch",
                     "ab_attention_torch", "time_attention_parts_torch",
                     "time_decode_parts_torch", "time_decode_i8_torch",
                     "time_cache_attention_torch", "time_cache_attention_parts_torch",
                     "e2e_demo_torch", "bench_pipeline_torch", "convert_kinetics_torch",
                     "bench_sample_torch", "bench_train_torch", "probe_int8_noise_torch",
                     "time_i8w_vq_parts_torch", "quality_int8_torch", "convert_i3d_torch",
                     "trace_summary_torch", "mfu_torch", "soak_train_torch", "chip_smoke"]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "lvt_tpu"))
print(len(names), bad)
assert not bad, bad
""".format(root=ROOT, scripts=os.path.join(ROOT, "scripts"), tools=os.path.join(ROOT, "tools"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"  # the test workers share the cores
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 35  # the walk saw the whole package
