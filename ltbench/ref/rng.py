"""Counter-based per-particle random streams (counterpart of ``ltjax.rng``).

A Threefry-2x32 block (20 rounds, the ``jax.random`` core) per (seed,
step, substream, particle id): order- and sharding-invariant, and
bit-exact with ``ltjax.rng`` and the CUDA kernel
(``kernels/csrc/ext_step.cu``), so a turbulent run draws the same numbers
in all three.

Words are uint32 values held in int64 tensors: PyTorch's CPU kernels
have no uint32 ``+``, ``<<`` or ``>>``, so the arithmetic runs in int64
and is masked to 32 bits after every add and shift.  A key word may also
be a Python int: the per-particle draws derive the (step, substream) key
on the host in Python ints and pass it as such, so a draw on a CUDA
tensor copies nothing to the device and waits for nothing.

The seed.  ``ltjax.run`` derives its streams from ``jax.random.key(seed)``
whose key words are (seed >> 32, seed & 0xFFFFFFFF) with 64-bit integers
enabled; ``seed_words`` reads an int seed that way.  (``ltjax.rng
.seed_words`` reads a bare int the other way round, (low, high), and
without 64-bit integers ``jax.random.key`` keeps only the low word.)  A
pair of words, e.g. the ``key_data`` of a JAX key, is taken as it is.
"""

from __future__ import annotations

import torch

# substream ids (ltjax.rng)
HTURB = 0
VTURB = 1
BEHAVE = 2
MORTALITY = 3   # behavior random-walk mixing draw
DEATH = 4       # stochastic-mortality survival draw

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)


def _words(v, like=None) -> torch.Tensor:
    """An int64 tensor of uint32 words (ints, tensors, numpy arrays)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & MASK
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(v, dtype=torch.int64, device=dev) & MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds.  Args are uint32 words (broadcastable;
    the keys may be Python ints); returns two int64 tensors of uint32
    words, or two Python ints when every arg is one."""
    if all(isinstance(v, int) for v in (k0, k1, x0, x1)):
        k0, k1, x0, x1 = (v & MASK for v in (k0, k1, x0, x1))
    else:
        x0 = _words(x0)
        x1 = _words(x1, x0)
        k0 = k0 & MASK if isinstance(k0, int) else _words(k0, x0)
        k1 = k1 & MASK if isinstance(k1, int) else _words(k1, x0)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for block in range(5):
        for r in range(4):
            rot = _ROT[(block % 2) * 4 + r]
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << rot) & MASK) | (x1 >> (32 - rot))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & MASK
    return x0, x1


def seed_words(seed):
    """(k0, k1) words of a seed: an int as ``jax.random.key(seed)`` with
    64-bit integers, or a pair of words as given."""
    if isinstance(seed, int):
        return (seed >> 32) & MASK, seed & MASK
    k0, k1 = (int(v) for v in seed)
    return k0 & MASK, k1 & MASK


def stream_key(seed, step, substream: int):
    """Per-(step, substream) derived key pair: two Python ints for an int
    step, else two int64 word tensors."""
    k0, k1 = seed_words(seed)
    if isinstance(step, int):
        return threefry2x32(k0, k1, step, substream)
    step = _words(step)
    return threefry2x32(k0, k1, step, torch.full_like(step, substream))


def particle_bits(sk0, sk1, pids):
    """Two words per particle for a derived stream key."""
    p = _words(pids)
    return threefry2x32(sk0, sk1, p, torch.zeros_like(p))


def bits_to_uniform(bits, dtype=torch.float32):
    """Word -> (0, 1): the top 24 bits, offset half an ulp from 0."""
    top = (bits >> 8).to(dtype)
    return top * (2.0 ** -24) + (2.0 ** -25)


def box_muller(b0, b1, dtype=torch.float32):
    """Two N(0,1) deviates from two words."""
    u1 = bits_to_uniform(b0, dtype)
    u2 = bits_to_uniform(b1, dtype)
    r = torch.sqrt(-2.0 * torch.log(u1))
    th = torch.full((), 2.0 * 3.14159265358979, dtype=dtype,
                    device=u2.device) * u2
    return r * torch.cos(th), r * torch.sin(th)


def _bits(seed, step, substream, pids):
    sk0, sk1 = stream_key(seed, step, substream)      # on the host
    return particle_bits(int(sk0), int(sk1), pids)


def normal(seed, step, substream, pids, shape_per=(),
           dtype=torch.float32):
    """N(0,1) per particle; shape_per () or (2,) (one Threefry block)."""
    n0, n1 = box_muller(*_bits(seed, step, substream, pids), dtype)
    if shape_per == ():
        return n0
    if shape_per == (2,):
        return torch.stack([n0, n1], dim=-1)
    raise NotImplementedError(f"normal: shape_per {shape_per}")


def uniform(seed, step, substream, pids, shape_per=(), minval=0.0,
            maxval=1.0, dtype=torch.float32):
    """U(minval, maxval) per particle; shape_per () or (2,)."""
    b0, b1 = _bits(seed, step, substream, pids)
    lo = torch.full((), minval, dtype=dtype, device=pids.device)
    span = torch.full((), maxval, dtype=dtype, device=pids.device) - lo
    u0 = lo + span * bits_to_uniform(b0, dtype)
    if shape_per == ():
        return u0
    if shape_per == (2,):
        return torch.stack([u0, lo + span * bits_to_uniform(b1, dtype)],
                           dim=-1)
    raise NotImplementedError(f"uniform: shape_per {shape_per}")
