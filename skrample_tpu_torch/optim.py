"""8-bit block-quantized AdamW and bf16 stochastic rounding.

The port's counterpart of the JAX package's ``optim.py``.  Adam keeps two
float32 moments a parameter, 8 bytes; :class:`AdamW8bit` keeps each moment
as int8 codes in blocks of ``block`` elements with one float32 scale a
block (about 2.03 bytes a parameter at block 256), the design of
"8-bit Optimizers via Block-wise Quantization" (Dettmers et al., arXiv
2110.02861) with the JAX package's analytic code instead of a lookup table:

* the first moment stores ``round(127 * cbrt(m / absmax))``, the second
  ``round(127 * (v / max) ** 0.25)``; decoding is a cube or a fourth power,
  elementwise, and an all-zero block scales by 1;
* leaves under ``min_quant_size`` elements (gains, biases) keep float32
  moments.

The arithmetic is the JAX package's, operation for operation: optax's
decoupled decay ``upd = -lr * (step + wd * p)`` (PyTorch's AdamW instead
multiplies the parameter by ``1 - lr * wd`` first), the bias corrections
``1 - b ** count`` in float32, and ``cast_updates`` (False keeps float32
updates for :func:`apply_updates_sr`).  PyTorch has no ``cbrt``: the cube
root is taken in float64 and rounded once, so a code can differ from XLA's
where ``127 * cbrt`` lies within an ulp of a half.  The update is plain
PyTorch ops, as the JAX package leaves it to XLA to fuse: one pass a leaf,
no kernel of its own.

:func:`stochastic_round_bf16` and :func:`apply_updates_sr` round float32
sums into bfloat16 parameters up or down with probability proportional to
the distance, from ``prng``'s threefry bits (jax's bits, bit for bit), one
stream a leaf folded from the step's key by the leaf's index in jax's
tree-flatten order: given the same float32 sums the result is the JAX
package's, bit for bit.  Pass parameters in that order
(:func:`skrample_tpu_torch.models.lora.jax_leaves`), not in a module's
registration order.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Iterable, Mapping, Sequence
from typing import Any, NamedTuple

import torch

from . import prng

__all__ = [
    "AdamW8State",
    "AdamW8bit",
    "Moment8",
    "MomentF32",
    "adamw8bit_init",
    "adamw8bit_update",
    "apply_updates_sr",
    "optimizer_state_bytes",
    "stochastic_round_bf16",
]

_MASK32 = 0xFFFFFFFF


class Moment8(NamedTuple):
    "A quantized leaf's Adam state: int8 codes and f32 block scales."

    mq: torch.Tensor  # int8 (blocks, block): cbrt-coded first moment
    ms: torch.Tensor  # f32 (blocks, 1): its block absmax
    vq: torch.Tensor  # int8 (blocks, block): fourth-root-coded second moment
    vs: torch.Tensor  # f32 (blocks, 1): its block max


class MomentF32(NamedTuple):
    "A small leaf's full-precision state."

    m: torch.Tensor
    v: torch.Tensor


class AdamW8State(NamedTuple):
    count: torch.Tensor  # int32 0-d step count (bias correction)
    moments: list  # a Moment8 or MomentF32 a leaf, in the parameters' order


def _pack(x: torch.Tensor, block: int) -> torch.Tensor:
    "Flatten to (blocks, block) f32, zero-padded to a block multiple."
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block)


def _unpack(x: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    return x.reshape(-1)[: math.prod(shape)].reshape(shape)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    "The real cube root in float32: taken in float64 and rounded once."
    return (torch.sign(x) * x.double().abs().pow(1.0 / 3.0)).float()


def _block_scale(s: torch.Tensor) -> torch.Tensor:
    return torch.where(s == 0, torch.ones_like(s), s)


def _quant_signed(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    "(codes, scales): codes are round(127 * cbrt(x / blockabsmax))."
    s = _block_scale(x.abs().amax(dim=1, keepdim=True))
    return torch.round(127.0 * _cbrt(x / s)).to(torch.int8), s


def _dequant_signed(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    t = q.float() * (1.0 / 127.0)
    return t * t * t * s


def _quant_pos(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    "(codes, scales) for non-negative x: round(127 * (x / blockmax) ** (1/4))."
    s = _block_scale(x.amax(dim=1, keepdim=True))
    return torch.round(127.0 * torch.sqrt(torch.sqrt(x / s))).to(torch.int8), s


def _dequant_pos(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    t = q.float() * (1.0 / 127.0)
    t2 = t * t
    return t2 * t2 * s


def adamw8bit_init(
    params: Sequence[torch.Tensor], block: int = 256, min_quant_size: int = 4096, count_device: Any = None
) -> AdamW8State:
    """The JAX ``adamw8bit(...).init``: zero codes with unit scales a quantized leaf, zero f32 moments a
    leaf under ``min_quant_size`` elements, and the count 0 (int32, on ``count_device``: the first
    parameter's device unless given).  A rank's part of an FSDP-sharded leaf (``parallel.fsdp``: whole
    blocks of the flattened leaf, ``fsdp_numel`` its whole size) gets the blocks of its range: the
    blocks axis of the moments, sharded."""
    moments: list = []
    for p in params:
        # a rank's part of an FSDP-sharded leaf is quantized as the whole leaf is (parallel/fsdp.py)
        if getattr(p, "fsdp_numel", p.numel()) < min_quant_size:
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            moments.append(MomentF32(z, z.clone()))
        else:
            blocks = -(-p.numel() // block)
            q = torch.zeros((blocks, block), dtype=torch.int8, device=p.device)
            s = torch.ones((blocks, 1), dtype=torch.float32, device=p.device)
            moments.append(Moment8(q, s, q.clone(), s.clone()))
    device = count_device if count_device is not None else (params[0].device if params else "cpu")
    return AdamW8State(torch.zeros((), dtype=torch.int32, device=device), moments)


def adamw8bit_update(
    grads: Sequence[torch.Tensor],
    state: AdamW8State,
    params: Sequence[torch.Tensor],
    learning_rate: float | Callable[[torch.Tensor], Any] = 1e-4,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 1e-4,
    block: int = 256,
    cast_updates: bool = True,
) -> tuple[list[torch.Tensor], AdamW8State]:
    """The JAX ``adamw8bit(...).update``: ``(updates, new state)``, leaf for leaf in the parameters'
    order.  The count, the learning rate of a callable and the bias corrections are tensors on the
    count's device: nothing is read back, so a CUDA graph can capture the update."""
    count = state.count + 1
    cf = count.float()
    lr = learning_rate(count) if callable(learning_rate) else learning_rate
    one = torch.ones((), dtype=torch.float32, device=count.device)
    c1 = one - torch.pow(one * b1, cf)
    c2 = one - torch.pow(one * b2, cf)
    updates, moments = [], []
    for g, p, mom in zip(grads, params, state.moments, strict=True):
        gf = g.float()
        if isinstance(mom, MomentF32):
            m = b1 * mom.m + (1.0 - b1) * gf
            v = b2 * mom.v + (1.0 - b2) * gf * gf
            step = (m / c1) / (torch.sqrt(v / c2) + eps)
            new: Any = MomentF32(m, v)
        else:
            gp = _pack(gf, block)
            m = b1 * _dequant_signed(mom.mq, mom.ms) + (1.0 - b1) * gp
            v = b2 * _dequant_pos(mom.vq, mom.vs) + (1.0 - b2) * gp * gp
            step = _unpack((m / c1) / (torch.sqrt(v / c2) + eps), g.shape)
            new = Moment8(*_quant_signed(m), *_quant_pos(v))
        upd = -lr * (step + weight_decay * p.float())
        updates.append(upd.to(p.dtype) if cast_updates else upd)
        moments.append(new)
    return updates, AdamW8State(count, moments)


def stochastic_round_bf16(key: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Round float32 ``x`` to bfloat16 stochastically (the expected value is ``x``): 16 random bits
    from ``prng.random_bits(key, x.shape)`` are added below the cut of the f32 bits, which are then
    truncated, as the JAX package's uint32 add does (here in int64 masked to 32 bits).  Non-finite
    values pass through as XLA converts them: an infinity exactly, a NaN as the quiet NaN of its
    sign.  The result is built as 16-bit words, so no float conversion touches it."""
    bits = x.float().view(torch.int32).to(torch.int64) & _MASK32
    noise = prng.random_bits(key, tuple(x.shape), 32, device=x.device) & 0xFFFF
    top = ((bits + noise) & _MASK32) >> 16
    top = torch.where(torch.isfinite(x), top, bits >> 16)
    top = torch.where(torch.isnan(x), torch.where(bits >= 2**31, 0xFFC0, 0x7FC0), top)
    return torch.where(top >= 2**15, top - 2**16, top).to(torch.int16).view(torch.bfloat16)


def apply_updates_sr(
    params: Sequence[torch.Tensor], updates: Sequence[torch.Tensor], key: torch.Tensor | None
) -> list[torch.Tensor]:
    """``optax.apply_updates`` with stochastic rounding: each sum in float32, bfloat16 leaves rounded
    by :func:`stochastic_round_bf16` with ``fold_in(key, i)`` for leaf ``i`` (jax's flatten order:
    pass the parameters in it), the rest cast to their dtype.  ``key=None`` rounds to nearest.  Pass
    a fresh key every step.  Returns new tensors; the caller copies them into its parameters."""
    out = []
    for i, (p, u) in enumerate(zip(params, updates, strict=True)):
        s = p.float() + u.float()
        if p.dtype == torch.bfloat16 and key is not None:
            out.append(stochastic_round_bf16(prng.fold_in(key, i), s))
        else:
            out.append(s.to(p.dtype))
    return out


def _leaves(tree: Any) -> Iterable[Any]:
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def optimizer_state_bytes(state: Any) -> int:
    "Total bytes of the tensors in an optimizer state (nested tuples, lists, dicts; a ``state_dict()``)."
    return sum(t.numel() * t.element_size() for t in _leaves(state) if isinstance(t, torch.Tensor))


class AdamW8bit(torch.optim.Optimizer):
    """AdamW with int8 block-quantized moments: the JAX package's ``adamw8bit`` as a
    ``torch.optim.Optimizer``.

    ``lr`` is a float or a callable of the step count (a 0-d int32 tensor, 1 at the first step).
    ``capturable=True`` keeps the count on the parameters' device and computes the bias
    corrections there, so a CUDA graph can capture :meth:`step`; otherwise the count lives on the
    CPU.  ``step(key=...)`` applies the updates with :func:`apply_updates_sr` (bfloat16 parameters
    rounded stochastically; pair with ``cast_updates=False``), leaf ``i`` being the ``i``-th
    parameter over all groups: give the parameters in jax's flatten order.  Without a key each
    parameter takes ``p + u`` rounded to its dtype.  The state (``state_dict()``) holds a leaf's
    ``Moment8`` or ``MomentF32`` fields by name and the shared ``"count"``; :meth:`load_state_dict`
    copies a saved state into the live tensors (dtypes kept: the f32 scales of a bfloat16
    parameter stay f32), so it may run after a CUDA graph captured :meth:`step`."""

    def __init__(
        self,
        params: Iterable[torch.Tensor] | Iterable[dict],
        lr: float | Callable[[torch.Tensor], Any] = 1e-4,
        betas: tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 1e-4,
        block: int = 256,
        min_quant_size: int = 4096,
        cast_updates: bool = True,
        capturable: bool = False,
    ) -> None:
        defaults = dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay, block=block)
        super().__init__(params, defaults)
        self.min_quant_size, self.cast_updates, self.capturable = min_quant_size, cast_updates, capturable

    def _params(self) -> list[torch.Tensor]:
        return [p for group in self.param_groups for p in group["params"]]

    def _ensure_state(self) -> None:
        "Build the moments and the count at the first step (outside any capture: the warm-up's)."
        if "count" in self.state:
            return
        params = self._params()
        device = params[0].device if self.capturable else torch.device("cpu")
        init = adamw8bit_init(params, self.param_groups[0]["block"], self.min_quant_size, count_device=device)
        self.state["count"] = init.count
        for p, mom in zip(params, init.moments):
            self.state[p] = mom._asdict()

    @torch.no_grad()
    def load_state_dict(self, state_dict: dict) -> None:
        saved = state_dict["state"]
        ids = [i for group in state_dict["param_groups"] for i in group["params"]]
        self._ensure_state()
        for pid, p in zip(ids, self._params(), strict=True):
            for name, value in saved[pid].items():
                self.state[p][name].copy_(value)
        self.state["count"].copy_(saved["count"])

    @torch.no_grad()
    def step(self, closure: Callable[[], Any] | None = None, key: torch.Tensor | None = None) -> Any:
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._ensure_state()
        count = self.state["count"]
        index = 0
        new_count = count
        for group in self.param_groups:
            live = [(i, p) for i, p in enumerate(group["params"], start=index) if p.grad is not None]
            index += len(group["params"])
            if not live:
                continue
            params = [p for _, p in live]
            moments = [(Moment8 if "mq" in self.state[p] else MomentF32)(**self.state[p]) for p in params]
            b1, b2 = group["betas"]
            updates, new = adamw8bit_update(
                [p.grad for p in params], AdamW8State(count, moments), params, group["lr"], b1, b2,
                group["eps"], group["weight_decay"], group["block"], self.cast_updates,
            )
            new_count = new.count
            for (i, p), u, mom in zip(live, updates, new.moments):
                for name, value in mom._asdict().items():
                    self.state[p][name].copy_(value)
                if key is not None and p.dtype == torch.bfloat16:
                    p.copy_(stochastic_round_bf16(prng.fold_in(key, i), p.float() + u.float()))
                elif u.dtype == p.dtype:
                    p.add_(u)
                else:
                    p.copy_(p.float() + u.float())
        count.copy_(new_count)
        return loss
