"""lvt_tpu_torch — the Latent Video Transformer on PyTorch and hand-written
CUDA kernels for NVIDIA Hopper (sm_90a), beside the JAX package ``lvt_tpu``.

Module names mirror ``lvt_tpu`` so each counterpart is easy to find. The
package imports ``torch`` and never ``jax`` or ``lvt_tpu``. Public functions
keep the JAX package's layouts: codes (b, nc, T, H, W), activations
channels-last (b, t, h, w, d), frames NHWC.

fp32 paths run in true fp32, as JAX on the CPU does: TF32 is turned off for
matmuls and for cuDNN convolutions (whose default is TF32) when this package
is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
