from .convert import (flatten, from_jax_autoencoder, from_jax_layer, from_jax_vqvae,
                      from_jax_vt)
from .io import (
    latest_checkpoint,
    load_checkpoint,
    prune_checkpoints,
    resume_or_load,
    save_checkpoint,
)

__all__ = ["flatten", "from_jax_autoencoder", "from_jax_layer", "from_jax_vqvae", "from_jax_vt",
           "latest_checkpoint", "load_checkpoint", "prune_checkpoints", "resume_or_load", "save_checkpoint"]
