"""The port's driver against the JAX driver: the lattice geometry with
inner="pcg" (see tests/test_torch_driver_ordered.py for the schedule and
the bars)."""

from test_torch_driver_ordered import run_both


def test_lattice_driver_pcg_matches_jax(monkeypatch):
    run_both(monkeypatch, "lattice", "pcg")
