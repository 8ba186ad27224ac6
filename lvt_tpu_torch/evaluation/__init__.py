"""Evaluation (counterpart of lvt_tpu/evaluation/): the evaluator protocol
and the loop that runs it, reconstruction MSE and bits/dim, the stage-1 ->
stage-2 code extraction, sampled-video dumps and FVD, and the weights of the
paired VQ-VAE and of the VT for sampling."""

from .codes_extractor import CodesExtractor
from .evaluator import DatasetEvaluator, DatasetEvaluators, inference_on_dataset
from .metrics import BitsEvaluator, MSEEvaluator
from .testing import flatten_results_dict, print_csv_format, verify_results
from .fvd import FVDEvaluator, frechet_distance, fvd_from_features
from .vt_sampler import VTSampler

__all__ = [
    "BitsEvaluator",
    "CodesExtractor",
    "DatasetEvaluator",
    "DatasetEvaluators",
    "MSEEvaluator",
    "VTSampler",
    "FVDEvaluator",
    "flatten_results_dict",
    "inference_on_dataset",
    "print_csv_format",
    "verify_results",
]
