"""Shared set-up of the benchmark's own tests (``python -m pytest benchmark``):
the harness on the path, one CPU thread a process, and a tiny configuration
of each kind of cell that the CPU runs end to end on the port's plain path."""

import copy
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))  # the port, at the checkout's root
torch.set_num_threads(1)

TINY_VT = {"NC": 2, "NV": 16, "KERNEL": [3, 1, 1], "STRIDE": [4, 1, 1], "DE": 16, "D": 32, "DA": 16,
           "BLOCKS_E": [[1, 4, 4]] * 2, "N_HEAD_E": [2, 2], "BLOCKS_D": [[1, 4, 4]] * 2,
           "N_HEAD_D": [2, 2], "N_PRIME": 1, "PAD_VALUE": -1, "SHARE_P": False,
           "SHARE_EMBEDDINGS": False, "CLASS_NUM": 0}
TINY_VQ = {"ENCODER": {"NAME": "ResEncoder", "IN_CHANNELS": 3, "NF": 16, "RES_CHANNELS": 8,
                       "OUT_CHANNELS": 16, "N_LAYERS": 1, "NORM": "", "SPECTRAL": False,
                       "OUT_ACTIVATION": ""},
           "GENERATOR": {"NAME": "ResDecoder", "IN_CHANNELS": 16, "NF": 16, "RES_CHANNELS": 8,
                         "OUT_CHANNELS": 3, "N_LAYERS": 1, "NORM": "", "SPECTRAL": False,
                         "OUT_ACTIVATION": "tanh"},
           "CODEBOOK": {"NUM": 2, "SIZE": 16, "DIM": 16, "EMA": True},
           "PIXEL_MEAN": [0.5, 0.5, 0.5], "PIXEL_STD": [0.5, 0.5, 0.5], "SCALE_TO_ZEROONE": True,
           "FRAME": [16, 16]}
TINY_TRAIN = {"SOLVER": {"IMS_PER_BATCH": 4, "OPTIMIZER_NAME": "rmsprop", "LR_G": 2e-05,
                         "RMSPROP": {"ALPHA_G": 0.95, "MOMENTUM_G": 0.9},
                         "LR_SCHEDULER_NAME": "Identity", "ACCUMULATION_STEPS": 1,
                         "OPT_STATE_DTYPE": "float32"},
              "TPU": {"COMPUTE_DTYPE": "float32", "FUSED_LAYER": True, "REMAT": True,
                      "REMAT_POLICY": "", "MESH_MODEL": 1, "SHARD_SPATIAL": False}}
TINY_CONFIG = {"name": "tiny", "dtype": "float32", "vt": TINY_VT, "vqvae": TINY_VQ,
               "train": TINY_TRAIN, "video": {"T": 4, "H": 4, "W": 4, "N_PRIME_TEST": 2}}
TINY_GEN = {"kind": "generate", "batch": 2, "staged_batches": 2,
            "check_rows": 2, "check_videos": 4,
            "sampler": {"KV_DTYPE": "native", "ATTN_IMPL": "xla", "WEIGHT_DTYPE": "native"}}
TINY_TRAIN_TRAFFIC = {"kind": "train", "pool": 8, "checked_steps": 3, "trace_steps": 2}
# float32 on the CPU: the plain path is the reference's arithmetic in
# another order, so every number sits at float32's rounding
TINY_GEN_LIMITS = {"limits": {"vt_gap": 1e-4, "code_gap": 1e-5, "frame_err": 1e-3}}
TINY_TRAIN_LIMITS = {"limits": {"loss_gap": 1e-5, "grad_gap": 1e-4, "update_gap": 1e-3}}


def tiny_cell(kind: str, **traffic):
    from lvtbench import cells

    gen = kind == "generate"
    tr = dict(copy.deepcopy(TINY_GEN if gen else TINY_TRAIN_TRAFFIC), **traffic)
    limits = TINY_GEN_LIMITS if gen else TINY_TRAIN_LIMITS
    return cells.Cell("tiny." + kind, 1, copy.deepcopy(TINY_CONFIG), tr, copy.deepcopy(limits),
                      [], [])


@pytest.fixture
def tiny():
    return tiny_cell
