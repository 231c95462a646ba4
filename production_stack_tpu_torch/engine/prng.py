"""Counter-based random numbers, bit for bit as ``jax.random`` makes them.

The JAX engine keys every sampled token with threefry2x32: the key of a
draw is ``fold_in(fold_in(key(engine seed), step), per-sequence seed)``
and the draw is ``categorical`` (Gumbel-argmax) under that key. This
module computes the same keys, bits, uniforms, Gumbel noise and draws
as batched tensor ops on any device, so a seeded request samples the
same tokens in both engines.

A key is its ``key_data``: a ``[..., 2]`` tensor of uint32 words. uint32
arithmetic is carried in int64 tensors masked with ``0xFFFFFFFF`` (every
intermediate stays below 2^62), which every device and op supports; the
cipher takes Python ints as well, so the engine's scalar keys (the
engine seed folded with a step) are computed on the host and no scalar
is ever copied to the device.
What is reproduced:

- ``key(seed)``: ``[0, seed mod 2^32]``, as ``jax.random.key`` gives it
  with 64-bit types off (the JAX package's setting);
- ``fold_in``: ``threefry2x32(key, (0, data mod 2^32))``;
- ``random_bits`` of 32 bits with ``jax_threefry_partitionable`` on (the
  default of jax 0.9): counts ``(0, i)`` for element ``i``, the two
  output words xor-ed;
- ``uniform`` in float32: the top 23 bits as the mantissa of a number in
  [1, 2), minus 1, scaled into [minval, maxval) and floored at minval;
- ``gumbel`` in the default ``"low"`` mode,
  ``-log(-log(uniform(minval=tiny, maxval=1)))``;
- ``categorical``: ``argmax(gumbel + logits)`` over the last axis;
- ``normal`` in float32: ``sqrt(2) * erf_inv(u)`` of a uniform draw on
  ``(-1, 1)``, with XLA's ``erf_inv`` (Giles' single-precision
  polynomials, each step rounded once as a fused multiply-add rounds it)
  and XLA's two branches of ``log1p``. It agrees with
  ``jax.random.normal`` to a few float32 ulps, not bit for bit: XLA's
  CPU ``log`` is an approximation of its own, one ulp off the
  correctly rounded one for some inputs.

The draw is a few hundred elementwise launches on a card; a threefry
kernel would make it one (no Pallas kernel computes it in the JAX
package, so it stays plain tensor ops here).
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
# Rotation schedule of threefry2x32 (two groups of four rounds,
# alternating) and the key-schedule parity constant.
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# Smallest normal float32 (numpy's finfo(float32).tiny).
_F32_TINY = 1.1754943508222875e-38


def _as_u32(x, device):
    """uint32 words of ``x``, taken mod 2^32: a Python int for an int, else
    an int64 tensor on ``device``."""
    if isinstance(x, (int, np.integer)):
        return int(x) & MASK32
    return torch.as_tensor(x, device=device).to(torch.int64) & MASK32


def _words(keys: torch.Tensor):
    """The two uint32 words of keys ``[..., 2]`` (key data of any integer
    dtype, e.g. JAX's uint32) as int64 tensors."""
    keys = keys.to(torch.int64) & MASK32
    return keys[..., 0], keys[..., 1]


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 block cipher (20 rounds) of the count words
    ``(x1, x2)`` under the key words ``(k1, k2)``: int64 tensors holding
    uint32 values, or Python ints, broadcast together. Returns the two
    output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def key(seed: int, device=None) -> torch.Tensor:
    """``key_data(jax.random.key(seed))``: ``[2]`` int64 words."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def key_data(keys: torch.Tensor) -> torch.Tensor:
    """The uint32 words of keys, as uint32 values in int64 (the identity:
    keys are carried as their data)."""
    return torch.stack(_words(keys), dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of keys ``[..., 2]`` with ``data`` (an int or
    a tensor broadcastable against ``keys[..., 0]``). Returns the folded
    keys, broadcast shape ``+ [2]``."""
    k1, k2 = _words(keys)
    y1, y2 = threefry2x32(k1, k2, 0, _as_u32(data, keys.device))
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit ``jax.random.bits(key, (n,))`` of every key: ``[..., n]``
    uint32 values in int64 (partitionable threefry)."""
    count = torch.arange(n, dtype=torch.int64, device=keys.device)
    k1, k2 = _words(keys)
    y1, y2 = threefry2x32(k1[..., None], k2[..., None], 0, count)
    return y1 ^ y2


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 ``jax.random.uniform(key, (n,), minval=, maxval=)`` of every
    key: ``[..., n]``."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000  # below 2^31
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # float32 bounds and their float32 difference, as scalars (a float32
    # tensor op with a Python scalar computes in float32).
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(floats * span + lo, min=lo)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """float32 ``jax.random.gumbel(key, (n,))`` ("low" mode) of every key:
    ``[..., n]``."""
    return -torch.log(-torch.log(uniform(keys, n, minval=_F32_TINY)))


# XLA's ErfInv32 (Giles, "Approximating the erfinv function"): the
# polynomial coefficients, highest power first, for w < 5 and w >= 5.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
# XLA's log1p switches from its small-argument rational form to
# log(1 + y) at |y| >= sqrt(2) - 1.
_LOG1P_SMALL = 0.41421356237309504880


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 ``erf_inv`` as XLA computes it: ``w = -log1p(-x^2)``, then
    one of two degree-8 polynomials in ``w - 2.5`` or ``sqrt(w) - 3``
    (each Horner step evaluated in float64 and rounded once, as a fused
    multiply-add rounds it), times ``x``; ``x`` times the largest float32
    at +-1, as XLA returns it."""
    y = -x * x
    w = -torch.where(y.abs() >= _LOG1P_SMALL, torch.log(1 + y),
                     torch.log1p(y))
    small = w < 5.0
    t = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0]).double()
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = torch.where(small, a, b).double()
        p = (c + p * t).float().double()
    out = p.float() * x
    return torch.where(x.abs() == 1, x * torch.finfo(torch.float32).max,
                       out)


def normal(keys: torch.Tensor, shape) -> torch.Tensor:
    """float32 ``jax.random.normal(key, shape)`` of every key ``[..., 2]``:
    ``[..., *shape]`` (see the module docstring for how close)."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape)) if shape else 1
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(keys, n, minval=lo, maxval=1.0)
    z = erf_inv(u) * float(np.float32(np.sqrt(2.0)))
    return z.reshape(keys.shape[:-1] + shape)


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, row)`` of each key ``[..., 2]`` and
    float32 logits row ``[..., n]``: the index of the largest
    ``gumbel + logits`` (the first one on a tie)."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)


def make_rng_keys(seed: int, step: int, seq_seeds) -> torch.Tensor:
    """Per-sequence keys of the JAX engine's sampling:
    ``fold_in(fold_in(key(seed), step), s)`` for each ``s`` of
    ``seq_seeds`` (a tensor). The base key is computed on the host.
    Returns ``seq_seeds.shape + [2]``."""
    seq_seeds = torch.as_tensor(seq_seeds)
    b1, b2 = threefry2x32(0, int(seed) & MASK32, 0, int(step) & MASK32)
    y1, y2 = threefry2x32(b1, b2, 0, _as_u32(seq_seeds, seq_seeds.device))
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)
