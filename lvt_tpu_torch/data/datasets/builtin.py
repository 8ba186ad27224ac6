"""Built-in dataset registration at the reference's hard-coded ./datasets
paths (reference: vidgen/data/datasets/builtin.py:16-50). Registration is
lazy — loaders only touch disk when DatasetCatalog.get runs."""

import os

from .bair import register_bair
from .kinetics import register_kinetics
from .latents import register_kinetics_latents, register_latents


def register_all_bair(root="datasets"):
    for name, dirname, phase, load_images in [
        ("bair_train", "bair", "train", True),
        ("bair_train_seq", "bair", "train", False),
        ("bair_test", "bair", "test", True),
        ("bair_test_seq", "bair", "test", False),
    ]:
        register_bair(name, os.path.join(root, dirname), phase, load_images)


def register_all_kinetics(root="datasets"):
    for name, dirname, phase, load_images in [
        ("kinetics_train", "kinetics600", "train", True),
        ("kinetics_train_seq", "kinetics600", "train", False),
        ("kinetics_test", "kinetics600", "test", True),
        ("kinetics_test_seq", "kinetics600", "test", False),
        ("kinetics_train256", "kinetics600", "train256", True),
        ("kinetics_train256_seq", "kinetics600", "train256", False),
        ("kinetics_test256", "kinetics600", "test256", True),
        ("kinetics_test256_seq", "kinetics600", "test256", False),
    ]:
        register_kinetics(name, os.path.join(root, dirname), phase, load_images)


register_all_bair()
register_all_kinetics()

register_latents("prdvqvae_train", "datasets/prdvqvae2/inference/bair_train_seq")
register_latents("prdvqvae_test", "datasets/prdvqvae2/inference/bair_test_seq")

register_kinetics_latents("kdvqvae_train", "datasets/K-DVQVAE/inference/kinetics_train_seq")
register_kinetics_latents("kdvqvae_test", "datasets/K-DVQVAE/inference/kinetics_test_seq")
