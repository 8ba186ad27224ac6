"""The import guard compares whole top-level module names."""

from lvtbench import guard


def test_port_passes():
    assert guard.forbidden_loaded(["lvt_tpu_torch", "lvt_tpu_torch.models.vt", "torch"]) == []


def test_jax_package_and_jax_refused():
    assert guard.forbidden_loaded(["lvt_tpu.models.vt", "torch"]) == ["lvt_tpu"]
    assert guard.forbidden_loaded(["jax.numpy", "jaxlib", "flax.linen"]) == ["flax", "jax", "jaxlib"]


def test_prefix_is_not_a_match():
    assert guard.forbidden_loaded(["jaxtyping", "lvt_tpu_extra", "flaxen"]) == []
