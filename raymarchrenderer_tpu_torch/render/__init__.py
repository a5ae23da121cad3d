"""Render configuration, ray generation, normals and the spectral schedule."""
