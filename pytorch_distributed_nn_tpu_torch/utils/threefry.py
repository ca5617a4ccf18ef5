"""JAX's default PRNG in torch integer ops: threefry2x32, with the key
derivations and the draws that sampled decoding uses, so that a seeded
stream drawn here is the JAX package's stream, token for token.

The JAX contract this reproduces (``jax_threefry_partitionable`` on, the
default from JAX 0.5; the PRNG ``threefry2x32``):

- a key is two uint32 words; :func:`prng_key` of a seed below 2^32 is
  ``(0, seed)``;
- :func:`fold_in` (key, d) and the i-th key of :func:`split` are the same
  hash, ``threefry2x32(key, (0, d))`` (``_threefry_split_foldlike``);
- :func:`random_bits` of a shape hashes each element's row-major index i
  as the counter ``(i >> 32, i & 0xffffffff)`` and keeps ``x0 ^ x1``;
- :func:`uniform` puts the top 23 bits in a float32 mantissa of [1, 2),
  subtracts 1, and maps to [minval, maxval), clipped below at minval;
- :func:`gumbel` is ``-log(-log(u))`` of a uniform on [tiny, 1) (JAX's
  ``mode="low"``, the default), and :func:`categorical` the argmax of
  logits plus Gumbel noise (first index on ties, as ``jnp.argmax``).

Keys are int64 tensors whose last axis holds the two words, each in
[0, 2^32); leading axes are a batch of keys (one a row). Every function
runs on the key's device, CPU or CUDA, with the same integer results;
the float steps (the log) may differ by rounding across devices and
libraries.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry-2x32 block of key (k0, k1) on the counter
    words (x0, x1), elementwise over broadcast int64 tensors of uint32
    values; returns the two output words."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: (..., 2) for an int or an int tensor
    of seeds in [0, 2^32)."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device)
    return torch.stack([(s >> 32) & _MASK, s & _MASK], dim=-1)


def _hash(key: torch.Tensor, hi, lo) -> torch.Tensor:
    x0, x1 = threefry2x32(key[..., 0], key[..., 1], hi, lo)
    return torch.stack([x0, x1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``data`` (an int, or a tensor broadcast
    against the key's batch axes) mixed into ``key``."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    return _hash(key, torch.zeros_like(d), d)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of one (2,) key: (num, 2) keys."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    return _hash(key[None], torch.zeros_like(i), i)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits (as int64 in [0, 2^32)) of ``shape`` from each key:
    (*key_batch, *shape)."""
    n = 1
    for d in shape:
        n *= int(d)
    i = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k = key.reshape(*lead, *([1] * len(shape)), 2)
    x0, x1 = threefry2x32(k[..., 0], k[..., 1], i >> 32, i & _MASK)
    return x0 ^ x1


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: (*key_batch, *shape)."""
    bits = random_bits(key, shape)
    one = 0x3F800000  # float32 1.0
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in float32."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: one key for the
    whole (..., V) array (its noise indexed over every element), or a
    batch of keys whose shape is the logits' leading shape (each key's
    noise over its own (V,) row, as under ``jax.vmap``)."""
    if key.shape[:-1] == logits.shape[:-1]:
        noise = gumbel(key, logits.shape[-1:])
    else:
        noise = gumbel(key, logits.shape)
    return torch.argmax(noise + logits, dim=-1)
