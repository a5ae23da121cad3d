"""Differentiable sphere tracing: the implicit-function march adjoint."""
