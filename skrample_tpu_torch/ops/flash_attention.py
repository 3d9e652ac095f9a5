"""Attention straight off the fused qkv projection.

:func:`flash_attention_qkv_forward` launches the hand-written kernel K2
(``csrc/flash_attention.cu``): it reads each head's q, k and v in place from
the packed ``(B, N, 3*H*d)`` output of the qkv matmul and writes the packed
``(B, N, H*d)`` layout, with the score matrix never leaving registers.  The
plain versions beside it (:func:`attention_reference`,
:func:`_packed_reference`, :func:`_qkv_reference`) are the CPU path and the
kernel's oracle.  Forward only: the training path (the logsumexp forward
and the backward kernels) is later work.
"""

from __future__ import annotations

import math

import torch

from . import _cuda

_LANE = 128
_LOG2E = 1.4426950408889634
_BLOCK = 64  # query rows per kernel block and keys per K/V tile


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention, (B, H, N, d) -> (B, H, N, d).

    Scores and softmax in float32 (inputs upcast exactly), probabilities
    cast back to the value dtype before the value product, which again
    accumulates in float32: the JAX package's einsum semantics."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _packed_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    "Plain attention on the packed (B, N, H*d) layout."
    B, N, D = q.shape
    d = D // heads

    def split(x: torch.Tensor) -> torch.Tensor:
        return x.reshape(B, N, heads, d).transpose(1, 2)

    out = attention_reference(split(q), split(k), split(v))
    return out.transpose(1, 2).reshape(B, N, D)


def _qkv_reference(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    "Split-then-plain attention on the fused qkv layout: the kernel's oracle."
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    return _packed_reference(q, k, v, heads)


def flash_attention_qkv_forward(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Kernel K2: ``(B, N, 3*H*d) -> (B, N, H*d)``, unmasked softmax attention.

    On CPU tensors this is :func:`_qkv_reference`.  On CUDA tensors it
    launches the kernel or raises: bf16 or fp16 (an f32 qkv has no tensor-
    core path in this kernel), contiguous, head dim 128, ``N`` a multiple of
    64."""
    if qkv.device.type == "cpu":
        return _qkv_reference(qkv, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention_qkv_forward: unsupported device {qkv.device}")
    if qkv.ndim != 3:
        raise ValueError(f"flash_attention_qkv_forward: qkv must be (B, N, 3*H*d), got {tuple(qkv.shape)}")
    B, N, D3 = qkv.shape
    if qkv.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(
            f"flash_attention_qkv_forward: dtype {qkv.dtype} unsupported on CUDA (bfloat16 or float16; "
            "run the model in a 16-bit compute dtype or use attention='full')"
        )
    if D3 % (3 * heads):
        raise ValueError(f"flash_attention_qkv_forward: packed width {D3} does not split into 3 x {heads} heads")
    d = D3 // 3 // heads
    if d != 128:
        raise ValueError(f"flash_attention_qkv_forward: head dim {d} unsupported (the kernel is built for 128)")
    if N % _BLOCK:
        raise ValueError(f"flash_attention_qkv_forward: token count {N} must be a multiple of {_BLOCK}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("flash_attention_qkv_forward: qkv must be contiguous and 16-byte aligned")
    out = torch.empty((B, N, D3 // 3), dtype=qkv.dtype, device=qkv.device)
    lib = _cuda.library()
    with torch.cuda.device(qkv.device):
        code = lib.skt_flash_attention_qkv(
            qkv.data_ptr(),
            out.data_ptr(),
            B,
            N,
            heads,
            d,
            _cuda.DTYPE_CODES[qkv.dtype],
            (1.0 / math.sqrt(d)) * _LOG2E,  # log2-domain scores, as the TPU kernel folds them
            _cuda.stream(),
        )
    _cuda.check(code, "flash_attention_qkv_forward")
    flash_attention_qkv_forward.launches += 1
    return out


flash_attention_qkv_forward.launches = 0


def flash_attention_qkv(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Fused-qkv attention ``(B, N, 3*H*d) -> (B, N, H*d)``.

    The JAX package's dispatch rule: the kernel where the packed width
    splits into ``heads`` heads of a multiple of 128 and ``N`` is a multiple
    of 128; split + plain attention otherwise."""
    _B, N, D3 = qkv.shape
    if D3 % (3 * heads) or (D3 // 3 // heads) % _LANE or N % _LANE:
        return _qkv_reference(qkv, heads)
    return flash_attention_qkv_forward(qkv, heads)
