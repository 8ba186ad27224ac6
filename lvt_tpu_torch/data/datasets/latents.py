"""Latent-code (.npy) dataset registration — the stage-1 -> stage-2 bridge
(reference: vidgen/data/datasets/latents.py). Walks the CodesExtractor output
layout <root>/[class/]video_<idx>/<frame>.npy with the same
``latent_video_paths.npy`` caches."""

import os

import numpy as np

from ...utils.labels import KINETICS_IDX_LABEL, KINETICS_LABEL_IDX
from ...utils.strings import natural_sorted
from ..catalog import DatasetCatalog, MetadataCatalog


def get_latent_video_paths(root, use_cache=True, is_kinetics=False, class_filter=None):
    assert os.path.isdir(root) or os.path.islink(root), f"{root} is not a valid directory"
    cache_path = os.path.join(root, "latent_video_paths.npy")
    if use_cache and os.path.exists(cache_path):
        video_paths = np.load(cache_path, allow_pickle=True).tolist()
    else:
        video_paths = []
        video_idx = 0
        for dirpath, dirs, files in os.walk(root):
            dirs[:] = natural_sorted(dirs)  # deterministic walk order (video_idx must not depend on readdir order)
            if dirs:
                continue
            # skip AppleDouble resource forks like the image walkers do
            # (utils/image.py) — '._frame.npy' ends with .npy but np.load
            # on its header raises mid-training
            files = natural_sorted(f for f in files if not f.startswith("._"))
            if not files or not all(f.endswith(".npy") for f in files):
                continue
            d = {"video_root": dirpath,
                 "latent_names": files,
                 "video_idx": video_idx}
            if is_kinetics:
                d["class"] = KINETICS_LABEL_IDX[dirpath.split("/")[-2]]
            video_paths.append(d)
            video_idx += 1
        if use_cache:
            try:
                np.save(cache_path, video_paths)
            except PermissionError:
                pass

    if class_filter is not None:
        video_paths = [v for v in video_paths
                       if KINETICS_IDX_LABEL[v["class"]] in class_filter]
    return video_paths


def register_latents(name, root):
    DatasetCatalog.register(name, lambda: get_latent_video_paths(root))
    MetadataCatalog.get(name).set(root=root)


def register_kinetics_latents(name, root, class_filter=None):
    DatasetCatalog.register(
        name, lambda: get_latent_video_paths(root, is_kinetics=True,
                                             class_filter=class_filter))
    MetadataCatalog.get(name).set(root=root)
