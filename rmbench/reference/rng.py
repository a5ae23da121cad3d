"""Counter-based per-pixel RNG: lowbias32 over a Weyl combination.

Bit-identical to the JAX package's `core/rng.py` by construction: every
random number is a pure function of (seed, px, py, folds..., counter), so
no `torch.Generator` is involved and the CUDA kernels reproduce the same
streams with native `uint32_t` arithmetic (`csrc/scene_map.cuh`).

torch has no usable uint32 arithmetic on the CPU (`>>` on `torch.uint32`
raises), so the plain version carries the 32-bit words in int64 tensors
and masks with `& 0xFFFFFFFF` after every multiply and add.  A multiply by
a 32-bit constant goes in two 16-bit halves (`_mul`), so no intermediate
leaves the positive int64 range and every masked result is exact.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_W0 = 0x9E3779B9
_W1 = 0x85EBCA6B
_W2 = 0xC2B2AE35
_W3 = 0x27D4EB2F


def _u32(a, device=None) -> torch.Tensor:
    """Any integer tensor or Python int -> int64 tensor holding its uint32
    bit pattern (two's complement for negative int32 values)."""
    t = torch.as_tensor(a, device=device)
    return t.to(torch.int64) & _M32


def _mul(a: torch.Tensor, w: int) -> torch.Tensor:
    """(a * w) mod 2**32 for a uint32 word `a` and a uint32 constant `w`."""
    lo = a * (w & 0xFFFF)
    hi = ((a * (w >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _avalanche(h: torch.Tensor) -> torch.Tensor:
    """lowbias32 finalizer (Chris Wellons): full-period bijection on uint32."""
    h = h ^ (h >> 16)
    h = _mul(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h


def hash_u32(a, b, c, d) -> torch.Tensor:
    """Mix four uint32 coordinate streams into one uint32 (in int64)."""
    a, b, c, d = _u32(a), _u32(b), _u32(c), _u32(d)
    h = _mul(a, _W0)
    h = _avalanche((h + _mul(b, _W1)) & _M32)
    h = _avalanche((h + _mul(c, _W2)) & _M32)
    h = _avalanche((h + _mul(d, _W3)) & _M32)
    return h


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 uniform in [0, 1) from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


class PixelRNG:
    """A stream handle fixing (seed, px, py, sample): `at(counter)` is the
    uniform of that use-counter, `bits(counter)` its uint32 (in int64).
    base = avalanche(seed * W2 + sample * W3), then the four-way hash of
    (px, py, base, counter), as the JAX package's `PixelRNG`."""

    __slots__ = ("seed", "px", "py", "base")

    def __init__(self, seed, px, py, sample):
        self.px = _u32(px)
        dev = self.px.device
        self.seed = _u32(seed, dev)
        self.py = _u32(py, dev)
        self.base = _avalanche((_mul(self.seed, _W2)
                                + _mul(_u32(sample, dev), _W3)) & _M32)

    def bits(self, counter) -> torch.Tensor:
        return hash_u32(self.px, self.py, self.base,
                        _u32(counter, self.px.device))

    def at(self, counter) -> torch.Tensor:
        """Uniform [0, 1) for an explicit use-counter."""
        return bits_to_uniform(self.bits(counter))


def uniform(seed, px, py, sample, counter) -> torch.Tensor:
    """One-shot functional form of `PixelRNG.at`."""
    return PixelRNG(seed, px, py, sample).at(counter)


class RNGStream:
    """Counter allocator over the counter-based hash: the k-th `.next()`
    draws slot k of the (px, py, base) stream, `base` folding in the
    seed and any per-lane values (sample index, bounce index)."""

    __slots__ = ("px", "py", "base", "_s2", "_counter")

    def __init__(self, seed, px, py, *folds):
        self.px = _u32(px)
        self.py = _u32(py, self.px.device)
        base = _mul(_u32(seed, self.px.device), _W2)
        for f in folds:
            base = _avalanche((base + _mul(_u32(f, self.px.device), _W3))
                              & _M32)
        self.base = base
        self._s2 = None
        self._counter = 0

    def _stage2(self) -> torch.Tensor:
        """The draw-invariant prefix of `hash_u32(px, py, base, ctr)`,
        computed once per stream (the same cached stage as the JAX
        package's `RNGStream._stage2`)."""
        if self._s2 is None:
            s1 = _avalanche((_mul(self.px, _W0) + _mul(self.py, _W1)) & _M32)
            self._s2 = _avalanche((s1 + _mul(self.base, _W2)) & _M32)
        return self._s2

    def next_bits(self) -> torch.Tensor:
        self._counter += 1
        return _avalanche((self._stage2() + (self._counter * _W3 & _M32))
                          & _M32)

    def next(self) -> torch.Tensor:
        """Fresh uniform [0, 1) tensor broadcast over the pixel coords."""
        return bits_to_uniform(self.next_bits())

    def fork(self, tag: int) -> "RNGStream":
        """Independent substream (Russian roulette, each light of NEE):
        base' = avalanche(base + tag * W1), counter from 0."""
        child = RNGStream.__new__(RNGStream)
        child.px, child.py = self.px, self.py
        child.base = _avalanche((self.base + (int(tag) * _W1 & _M32)) & _M32)
        child._s2 = None
        child._counter = 0
        return child
