"""Environment report (counterpart of lvt_tpu/utils/collect_env.py;
reference vidgen/utils/collect_env.py:56-142): Python, numpy, torch and its
CUDA, nvcc, the GPU's name and power limit as nvidia-smi prints them, and
whether the native IO library loaded. Every probe reports its failure
instead of raising: the report runs on machines with no GPU and no CUDA
toolkit."""

import importlib
import os
import platform
import shutil
import subprocess
import sys

__all__ = ["collect_env_info"]


def collect_env_info() -> str:
    import torch

    from .. import native

    data = [("sys.platform", sys.platform),
            ("Python", sys.version.replace("\n", "")),
            ("numpy", _version("numpy")),
            ("torch", torch.__version__),
            ("torch CUDA", torch.version.cuda or "none (CPU build)"),
            ("CUDA available", str(torch.cuda.is_available()))]
    if torch.cuda.is_available():
        data.append(("GPU count", str(torch.cuda.device_count())))
        data.append(("GPU 0", torch.cuda.get_device_name(0)))
    data.append(("nvidia-smi name, power.limit",
                 _run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"])))
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        nvcc = shutil.which("nvcc") or nvcc
    data.append(("nvcc", _run([nvcc, "--version"]).splitlines()[-1]))
    data.append(("native lvt_io", native.LIBRARY.path if native.available() else
                 "not loaded (PIL and numpy fallback)"))
    data.append(("PIL", _version("PIL")))
    data.append(("platform", platform.platform()))
    for var in ("CUDA_VISIBLE_DEVICES", "CUDA_HOME"):
        if os.environ.get(var):
            data.append((var, os.environ[var]))
    width = max(len(k) for k, _ in data)
    return "\n".join(f"{k:<{width}}  {v}" for k, v in data)


def _run(cmd) -> str:
    """A command's output, stripped, or what kept it from running."""
    try:
        out = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e.__class__.__name__}: {e})"
    text = out.stdout.strip() or "(no output)"
    return text if out.returncode == 0 else f"failed ({out.returncode}): {text}"


def _version(mod_name: str) -> str:
    try:
        mod = importlib.import_module(mod_name)
        return getattr(mod, "__version__", "unknown")
    except ImportError:
        return "not installed"
