"""Threefry-2x32 and the four ``jax.random`` operations the fern uses.

The JAX package takes its random numbers from ``jax.random``; the port
keeps its own generator, bit-equal to JAX's default ``threefry2x32``
implementation in the partitionable layout (``jax_threefry_partitionable``
on, the default of JAX 0.9): there ``split`` and the random bits hash a
64-bit counter per output element, (high word, low word), and every
operation below is one Threefry block of a key over such a counter:

    PRNGKey(seed)      key = (seed >> 32, seed & 0xFFFFFFFF)
    fold_in(key, i)    block(key, (0, i))
    split(key)         block(key, (0, 0)), block(key, (0, 1))
    bits(key, (k,))[i] b0 ^ b1 of block(key, (0, i))
    uniform            bitcast((bits >> 9) | 0x3F800000) - 1.0, in [0, 1)

The key chain of a walk is short, sequential and independent of the data,
so it runs on the host in Python integers (``key_chain``); the uniforms
are drawn for many keys at once on tensors (``uniform``).  Torch has no
unsigned 32-bit arithmetic on every device, so the tensor form works on
int32: adds wrap, ``<<`` drops the high bits and the logical right shift
is an arithmetic one with the sign extension masked off.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF

Key = Tuple[int, int]


def block(key: Key, counter: Key) -> Key:
    """One Threefry-2x32 block (20 rounds) on Python integers."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ _PARITY)
    x0 = (counter[0] + ks[0]) & _M32
    x1 = (counter[1] + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) & _M32) | (x1 >> (32 - r))
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``'s key data for a 64-bit integer seed."""
    seed = int(seed)
    return (seed >> 32) & _M32, seed & _M32


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    return block(key, (0, int(data) & _M32))


def split(key: Key) -> Tuple[Key, Key]:
    """``jax.random.split(key)``: the two new keys."""
    return block(key, (0, 0)), block(key, (0, 1))


@functools.lru_cache(maxsize=16)
def key_chain(seed: int, fold: int, steps: int) -> np.ndarray:
    """The subkeys of ``steps`` successive ``key, sub = split(key)`` from
    ``fold_in(PRNGKey(seed), fold)``, as uint32 (steps, 2)."""
    key = fold_in(prng_key(seed), fold)
    subs = np.empty((steps, 2), np.uint32)
    for i in range(steps):
        key, subs[i] = split(key)
    subs.setflags(write=False)
    return subs


def _rotl(x, r: int):
    low = torch.bitwise_right_shift(x, 32 - r).bitwise_and_((1 << r) - 1)
    return torch.bitwise_left_shift(x, r).bitwise_or_(low)


def block_tensor(k0, k1, x0, x1):
    """One Threefry-2x32 block on int32 tensors holding the uint32 bit
    patterns; the arguments broadcast against each other."""
    ks = (k0, k1, torch.bitwise_xor(torch.bitwise_xor(k0, k1), _PARITY))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0.add_(x1)
            x1 = _rotl(x1, r).bitwise_xor_(x0)
        x0 = x0.add_(ks[(i + 1) % 3])
        x1 = x1.add_(ks[(i + 2) % 3]).add_(i + 1)
    return x0, x1


def random_bits(keys: np.ndarray, k: int, device, counter0: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)[counter0:counter0 + k]`` for
    each key of ``keys`` (uint32 (s, 2)) and any n past the slice, as the
    int32 bit patterns, (s, k) on ``device``: element i hashes counter i
    alone, so a slice of the stream is drawn without the rest."""
    if counter0 < 0 or counter0 + k >= 1 << 31:
        raise ValueError("counters past 2^31 elements are not supported")
    words = torch.tensor(np.asarray(keys, np.uint32).view(np.int32), device=device)
    lo = torch.arange(counter0, counter0 + k, dtype=torch.int32, device=device)
    b0, b1 = block_tensor(words[:, 0:1], words[:, 1:2], torch.zeros_like(lo), lo)
    return b0.bitwise_xor_(b1)


def uniform(keys: np.ndarray, k: int, device, counter0: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32)[counter0:counter0 + k]`` for
    each key of ``keys`` (uint32 (s, 2)): f32 (s, k) in [0, 1) on ``device``.  JAX's closing
    ``max(0, .)`` is left out: 23 mantissa bits under exponent 0 lie in
    [1, 2), so the difference is never negative."""
    bits = random_bits(keys, k, device, counter0)
    mant = torch.bitwise_right_shift(bits, 9).bitwise_and_(0x7FFFFF).bitwise_or_(0x3F800000)
    return mant.view(torch.float32) - 1.0
