"""The port's top-level names against the JAX package's: every name the
JAX package exports (its ``__all__``, eager and lazy) that the port
implements is a top-level name of the port, listed in its ``__all__`` and
bound to the port's own object, on the CPU."""

import importlib

import pytest

import homogenization_jl_tpu as jax_pkg
import homogenization_jl_tpu_torch as port


def _submodule(name):
    """The JAX package's module of ``name``, relative to the package."""
    lazy = getattr(jax_pkg, "_LAZY", {})
    if name in lazy:
        return lazy[name].lstrip(".")
    return getattr(jax_pkg, name).__module__.split(".", 1)[1]


@pytest.mark.parametrize("name", sorted(set(jax_pkg.__all__)))
def test_jax_export_is_a_top_level_name_of_the_port(name):
    mod = importlib.import_module(f"homogenization_jl_tpu_torch.{_submodule(name)}")
    assert hasattr(mod, name), f"{name}: not in homogenization_jl_tpu_torch.{_submodule(name)}"
    assert name in port.__all__
    assert getattr(port, name) is getattr(mod, name)


def test_port_all_names_resolve_without_jax_objects():
    for name in port.__all__:
        obj = getattr(port, name)
        assert getattr(obj, "__module__", "").startswith("homogenization_jl_tpu_torch"), name
    from homogenization_jl_tpu_torch import checkerboard_homogenization
    from homogenization_jl_tpu_torch.models.checkerboard import checkerboard_homogenization as f

    assert checkerboard_homogenization is f
