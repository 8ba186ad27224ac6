"""Latent-code datasets at the reference's hard-coded ./datasets paths
(lvt_tpu/data/datasets/builtin.py:39-43). Registration is lazy: nothing
touches the disk until DatasetCatalog.get runs."""

from .latents import register_kinetics_latents, register_latents

register_latents("prdvqvae_train", "datasets/prdvqvae2/inference/bair_train_seq")
register_latents("prdvqvae_test", "datasets/prdvqvae2/inference/bair_test_seq")

register_kinetics_latents("kdvqvae_train", "datasets/K-DVQVAE/inference/kinetics_train_seq")
register_kinetics_latents("kdvqvae_test", "datasets/K-DVQVAE/inference/kinetics_test_seq")
