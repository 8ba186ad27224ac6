"""Plain PyTorch references of the benchmark's configurations.

Each module computes one model of ``benchmark/configs/<name>.json`` with
plain ``torch`` operations in float32 (TF32 off), from the weights and
inputs the benchmark makes: the subscale Video Transformer (``vt``), the
VQ-VAE (``vqvae``), RMSprop (``optim``). They are frozen copies of the plain
paths of the PyTorch port, written against the configuration files, and
import nothing of the port, of JAX or of the JAX package. ``precision`` gives
the lower precisions of the controls.
"""
