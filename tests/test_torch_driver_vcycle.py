"""The port's driver against the JAX driver with inner="vcycle", the
reference's plain V-cycle inner loop: the lattice geometry, and the ordered
geometry with shrink=False (the fixed-domain variant: one plan and solver,
only lambda and the integration box change). See
tests/test_torch_driver_ordered.py for the schedule and the bars."""

from test_torch_driver_ordered import run_both


def test_lattice_driver_vcycle_matches_jax(monkeypatch):
    run_both(monkeypatch, "lattice", "vcycle")


def test_ordered_driver_fixed_domain_matches_jax(monkeypatch):
    run_both(monkeypatch, "ordered", "vcycle", shrink=False)
