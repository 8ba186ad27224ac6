"""Evaluation (counterpart of lvt_tpu/evaluation/). So far only the weight
loading of the sampler: vt_sampler.load_paired_vqvae and load_vt_weights."""
