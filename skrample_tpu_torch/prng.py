"""jax.random's default generator (threefry2x32) in plain PyTorch.

The JAX package seeds every request through ``jax.random``: a request's
``PRNGKey(seed)`` is split into an initial-latent key and a step-noise key,
and each draws normals.  This module computes the same keys and the same
random bits, bit for bit, on any device, so a seed gives the port the
latent it gives the reference.  It follows jax's counter layout with
``jax_threefry_partitionable`` on (the default since jax 0.5):

* ``PRNGKey(s)`` is the word pair ``(s >> 32, s & 0xffffffff)``;
* ``split(key, n)[i]`` is both output words of threefry2x32 at counter
  ``(0, i)``, and ``fold_in(key, d)`` those at ``(0, d)``;
* the 32-bit random bits of a shape are ``x0 ^ x1`` of threefry2x32 at the
  counters ``(i >> 32, i & 0xffffffff)`` of the flat index ``i``; narrower
  bits are their low bits;
* ``uniform`` fills the mantissa of a float in [1, 2) with the top bits and
  subtracts 1 (8 bits for bfloat16, 16 for float16, 32 for float32), then
  scales to ``[minval, maxval)``, rounding where XLA rounds; ``normal`` is
  ``sqrt(2) * erfinv(u)`` of a uniform on ``[nextafter(-1, 0), 1)``.

The bits and the uniforms equal jax's exactly; a normal's erfinv is
PyTorch's, which agrees with XLA's to a few float32 ulps (exactly, once
rounded, in bfloat16).  Words are held in int64 tensors masked to 32 bits,
so the same code runs on the CPU and the card.  A key is a CPU int64
tensor of shape (2,): it is tiny, and drawing reads it on the host.  Draws
land on the card unless the caller passes ``device="cpu"``, as every entry
point of the port does.
"""

from __future__ import annotations

import math

import torch

from .ops._cuda import resolve_device

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_MANTISSA_BITS = {torch.float32: 23, torch.bfloat16: 7, torch.float16: 10}
_INT_VIEW = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float16: torch.int16}


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds) of the counter words
    ``(x0, x1)`` (int64 tensors holding uint32 values) under ``key``."""
    k0, k1 = (int(w) for w in key.tolist())
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for r in range(5):
        for rot in _ROTATIONS[r % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, rot) ^ x0
        x0 = (x0 + ks[(r + 1) % 3]) & _MASK
        x1 = (x1 + ks[(r + 2) % 3] + r + 1) & _MASK
    return x0, x1


def PRNGKey(seed: int) -> torch.Tensor:  # noqa: N802 — jax's name
    "``jax.random.PRNGKey(seed)``: the (high, low) 32-bit words of the seed."
    seed = int(seed)
    if -(2**31) <= seed < 2**31:  # jax takes a Python int as int32: the high word is 0
        return torch.tensor([0, seed & _MASK], dtype=torch.int64)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK], dtype=torch.int64)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    "``jax.random.split(key, num)``: ``(num, 2)`` keys."
    x0, x1 = threefry2x32(key, torch.zeros(num, dtype=torch.int64), torch.arange(num, dtype=torch.int64))
    return torch.stack([x0, x1], dim=1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    "``jax.random.fold_in(key, data)``."
    x0, x1 = threefry2x32(key, torch.zeros(1, dtype=torch.int64), torch.tensor([int(data) & _MASK]))
    return torch.cat([x0, x1])


def random_bits(
    key: torch.Tensor, shape: tuple[int, ...], bit_width: int = 32, device: str | torch.device = "cuda"
) -> torch.Tensor:
    "``jax.random.bits(key, shape)`` at 8, 16 or 32 bits, as int64 values on ``device``."
    if bit_width not in (8, 16, 32):
        raise ValueError(f"bit_width must be 8, 16 or 32, got {bit_width}")
    device = resolve_device(device)
    count = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(key, count >> 32, count & _MASK)
    return ((x0 ^ x1) & ((1 << bit_width) - 1)).reshape(shape)


def permutation(key: torch.Tensor, n: int, device: str | torch.device = "cuda") -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (jax 0.9's ``_shuffle``): ``ceil(3 ln(n) / ln(2**32 - 1))``
    rounds, each ``key, sub = split(key)`` and a stable sort of ``arange(n)`` by 32 random bits of
    ``sub``.  The bits are non-negative int64, so the sort orders them as uint32."""
    device = resolve_device(device)
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(2**32 - 1))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[torch.sort(random_bits(sub, (n,), 32, device), stable=True).indices]
    return x


def _float(value: float, dtype: torch.dtype, device: str | torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=device)


def uniform(
    key: torch.Tensor,
    shape: tuple[int, ...],
    dtype: torch.dtype = torch.float32,
    minval: float = 0.0,
    maxval: float = 1.0,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """``jax.random.uniform``: the mantissa of a float in [1, 2) from the top
    random bits, minus 1, scaled to ``[minval, maxval)``: in a 16-bit
    ``dtype`` each operation rounded to it, as the JAX source writes it; in
    float32 with one rounding, as XLA fuses it."""
    if dtype not in _MANTISSA_BITS:
        raise ValueError(f"uniform draws float32, bfloat16 or float16, got {dtype}")
    device = resolve_device(device)
    nbits = torch.finfo(dtype).bits
    nmant = _MANTISSA_BITS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(key, shape, rng_bits, device)
    one = torch.tensor(1.0, dtype=dtype).view(_INT_VIEW[dtype]).item() & ((1 << nbits) - 1)
    floats = ((bits >> (rng_bits - nmant)) | one).to(_INT_VIEW[dtype]).view(dtype) - _float(1.0, dtype, device)
    lo, hi = _float(minval, dtype, device), _float(maxval, dtype, device)
    if dtype != torch.float32:  # the JAX source's 16-bit semantics: each operation rounded to dtype
        return torch.maximum(lo, floats * (hi - lo) + lo)
    # XLA scales and offsets float32 with one rounding (a fused multiply-add; the scale rounded to dtype)
    scaled = floats.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, scaled.to(dtype))


def normal(
    key: torch.Tensor, shape: tuple[int, ...], dtype: torch.dtype = torch.float32, device: str | torch.device = "cuda"
) -> torch.Tensor:
    "``jax.random.normal``: ``sqrt(2) * erfinv(u)`` of a uniform on ``[nextafter(-1, 0), 1)``, in ``dtype``."
    device = resolve_device(device)
    lo = -(1.0 - torch.finfo(dtype).eps / 2)  # nextafter(-1, 0) in dtype
    u = uniform(key, shape, dtype, lo, 1.0, device)
    return _float(math.sqrt(2), dtype, device) * torch.special.erfinv(u)


def randint(
    key: torch.Tensor, shape: tuple[int, ...], minval: int, maxval: int, device: str | torch.device = "cuda"
) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): ``k1, k2 = split(key)``, 32 random
    bits from each, and ``minval + (hi % span * (2**32 % span) + lo % span) % span`` with ``span =
    maxval - minval`` (1 where ``maxval <= minval``), every product and sum wrapping at 32 bits as
    jax's uint32 arithmetic does.  The bounds must lie in int32."""
    if not (-(2**31) <= minval < 2**31 and -(2**31) <= maxval < 2**31):
        raise ValueError(f"randint draws int32: bounds [{minval}, {maxval}) out of range")
    device = resolve_device(device)
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape, 32, device), random_bits(k2, shape, 32, device)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    multiplier = ((2**16 % span) ** 2 & _MASK) % span
    offset = ((higher % span * multiplier) & _MASK) + lower % span
    offset = (offset & _MASK) % span
    value = (offset + minval) & _MASK  # int32's wrap-around, as a uint32 word
    return (value - ((value >> 31) << 32)).to(torch.int32)


def bernoulli(
    key: torch.Tensor, p: float, shape: tuple[int, ...], device: str | torch.device = "cuda"
) -> torch.Tensor:
    "``jax.random.bernoulli(key, p, shape)``: ``uniform(key, shape) < p`` in float32, as booleans."
    device = resolve_device(device)
    return uniform(key, shape, torch.float32, device=device) < _float(p, torch.float32, device)
