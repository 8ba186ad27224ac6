from .convert import from_jax_vqvae, from_jax_vt

__all__ = ["from_jax_vqvae", "from_jax_vt"]
