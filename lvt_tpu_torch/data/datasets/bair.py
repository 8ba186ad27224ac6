"""BAIR robot-pushing dataset registration (reference: vidgen/data/datasets/bair.py)."""

import os

from ...utils.image import get_image_paths, get_video_paths
from ..catalog import DatasetCatalog, MetadataCatalog


def load_bair(root, phase, load_images):
    """list of dicts: per-image ({"image_path"}) or per-video
    ({"video_root", "image_names", "video_idx"})."""
    if load_images:
        return get_image_paths(os.path.join(root, phase))
    return get_video_paths(os.path.join(root, phase))


def register_bair(name, root, phase, load_images):
    DatasetCatalog.register(name, lambda: load_bair(root, phase, load_images))
    MetadataCatalog.get(name).set(root=root)
