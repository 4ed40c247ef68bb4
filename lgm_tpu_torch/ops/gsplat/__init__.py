"""Gaussian splat rendering: projection, flatsort binning, kernel K2."""
