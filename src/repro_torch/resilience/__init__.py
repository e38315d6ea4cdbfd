"""Numerical guards of the port (the subset of ``repro.resilience`` the
estimators use; fault injection and the retry ladder are not ported yet)."""

from repro_torch.resilience.guards import NumericalDivergence, require_finite_host

__all__ = ["NumericalDivergence", "require_finite_host"]
