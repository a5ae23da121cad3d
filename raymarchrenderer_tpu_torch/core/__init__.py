"""Vector math, RNG, SDFs, sampling, spectral colour and the camera."""
