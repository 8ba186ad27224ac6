"""Kinetics-600 dataset registration with class tagging from the parent
directory name (reference: vidgen/data/datasets/kinetics.py)."""

import os

from ...utils.image import get_image_paths, get_video_paths
from ..catalog import DatasetCatalog, MetadataCatalog


def load_kinetics(root, phase, load_images):
    if load_images:
        return get_image_paths(os.path.join(root, phase), is_kinetics=True)
    return get_video_paths(os.path.join(root, phase), is_kinetics=True)


def register_kinetics(name, root, phase, load_images):
    DatasetCatalog.register(name, lambda: load_kinetics(root, phase, load_images))
    MetadataCatalog.get(name).set(root=root)
