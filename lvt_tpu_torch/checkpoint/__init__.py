from .convert import (flatten, from_jax_autoencoder, from_jax_i3d, from_jax_layer,
                      from_jax_vqvae, from_jax_vt)
from .io import (
    latest_checkpoint,
    load_checkpoint,
    prune_checkpoints,
    resume_or_load,
    save_checkpoint,
)
from .torch_convert import (
    convert_codebook,
    convert_seqnet,
    convert_video_transformer,
    load_pretrained_vqvae,
    load_torch_state_dict,
)

__all__ = ["flatten", "from_jax_autoencoder", "from_jax_i3d", "from_jax_layer", "from_jax_vqvae",
           "from_jax_vt",
           "latest_checkpoint", "load_checkpoint", "prune_checkpoints", "resume_or_load",
           "save_checkpoint", "convert_codebook", "convert_seqnet", "convert_video_transformer",
           "load_pretrained_vqvae", "load_torch_state_dict"]
