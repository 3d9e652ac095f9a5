"""Attention straight off the fused qkv projection, with its gradient.

:func:`flash_attention_qkv_forward` launches the hand-written kernel K2
(``csrc/flash_attention.cu``): it reads each head's q, k and v in place from
the packed ``(B, N, 3*H*d)`` output of the qkv matmul and writes the packed
``(B, N, H*d)`` layout, with the score matrix never leaving registers.
:func:`flash_attention_qkv_forward_lse` (K4, the same kernel body) also
writes each row's logsumexp, and :func:`flash_attention_qkv_backward` (K5,
``csrc/flash_attention_bwd.cu``) recomputes the probabilities from it to
give the gradient in the packed qkv layout.  :func:`flash_attention_qkv`
ties them into a :class:`torch.autograd.Function`, as the JAX package's
``custom_vjp`` does.  :func:`flash_attention_pairs_forward` launches B10
(the same kernel body behind a strided entry point, head dim 64) on three
packed ``(B, N, H*64)`` tensors that may be strided views, such as the
``chunk(3)`` thirds of a fused qkv product; :func:`flash_attention_pairs` is
its autograd Function, with the plain version's gradient backward.  The
plain versions beside each kernel (:func:`attention_reference`,
:func:`_packed_reference`, :func:`_qkv_reference`,
:func:`_qkv_reference_lse`, :func:`_qkv_backward_reference`) are the CPU
path and the kernels' oracles.
"""

from __future__ import annotations

import ctypes
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


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    "(B, N, H*d) -> (B, H, N, d) float32"
    B, N, D = x.shape
    return x.reshape(B, N, heads, D // heads).transpose(1, 2).float()


def _merge(x: torch.Tensor) -> torch.Tensor:
    "(B, H, N, d) -> (B, N, H*d)"
    B, H, N, d = x.shape
    return x.transpose(1, 2).reshape(B, N, H * d)


def _qkv_reference_lse(qkv: torch.Tensor, heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain attention on the fused qkv layout that also returns the row
    logsumexp ``(B, H, N, 1)`` float32 in natural-log units: K4's oracle.

    Scores, statistics and the value product in float32; the probabilities
    round to the value dtype first, as in :func:`attention_reference`."""
    q, k, v = (_heads(part, heads) for part in torch.chunk(qkv, 3, dim=-1))
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse).to(qkv.dtype).float()
    return _merge(torch.matmul(p, v)).to(qkv.dtype), lse


def _qkv_backward_reference(
    qkv: torch.Tensor, o: torch.Tensor, lse: torch.Tensor, g: torch.Tensor, heads: int
) -> torch.Tensor:
    """Plain flash backward on the fused qkv layout: K5's oracle.

    The TPU kernels' arithmetic on whole matrices: float32 products of the
    inputs, ``P = exp(s - lse)``, ``delta = rowsum(g * o)``, and P and dS
    rounded to the input dtype before the products they feed."""
    dtype = qkv.dtype
    q, k, v = (_heads(part, heads) for part in torch.chunk(qkv, 3, dim=-1))
    do = _heads(g, heads)
    delta = (do * _heads(o, heads)).sum(-1, keepdim=True)
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(torch.matmul(q, k.transpose(-1, -2)) * scale - lse)
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), do)
    ds = (p * (torch.matmul(do, v.transpose(-1, -2)) - delta)).to(dtype).float()
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1).to(dtype)


def _check_qkv(qkv: torch.Tensor, heads: int, name: str) -> tuple[int, int, int]:
    "What K2, K4 and K5 take: raise on anything else; returns (B, N, head dim)."
    if qkv.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {qkv.device}")
    if qkv.ndim != 3:
        raise ValueError(f"{name}: qkv must be (B, N, 3*H*d), got {tuple(qkv.shape)}")
    B, N, D3 = qkv.shape
    if qkv.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(
            f"{name}: dtype {qkv.dtype} unsupported on CUDA (bfloat16 or float16; "
            "run the model in a 16-bit compute dtype or use attention='full')"
        )
    if D3 % (3 * heads):
        raise ValueError(f"{name}: packed width {D3} does not split into 3 x {heads} heads")
    d = D3 // 3 // heads
    if d != 128:
        raise ValueError(f"{name}: head dim {d} unsupported (the kernel is built for 128)")
    if N % _BLOCK:
        raise ValueError(f"{name}: token count {N} must be a multiple of {_BLOCK}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{name}: qkv must be contiguous and 16-byte aligned")
    return B, N, d


def flash_attention_qkv_forward(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Kernel K2: ``(B, N, 3*H*d) -> (B, N, H*d)``, unmasked softmax attention.

    On CPU tensors this is :func:`_qkv_reference`.  On CUDA tensors it
    launches the kernel or raises: bf16 or fp16 (an f32 qkv has no tensor-
    core path in this kernel), contiguous, head dim 128, ``N`` a multiple of
    64."""
    if qkv.device.type == "cpu":
        return _qkv_reference(qkv, heads)
    B, N, d = _check_qkv(qkv, heads, "flash_attention_qkv_forward")
    out = torch.empty((B, N, heads * d), dtype=qkv.dtype, device=qkv.device)
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


def flash_attention_qkv_forward_lse(qkv: torch.Tensor, heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K4: K2 that also returns the row logsumexp, ``(o, lse)`` with
    ``lse`` ``(B, H, N, 1)`` float32 in natural-log units (the JAX layout).

    On CPU tensors this is :func:`_qkv_reference_lse`; on CUDA tensors it
    launches the kernel or raises, on the same inputs as K2."""
    if qkv.device.type == "cpu":
        return _qkv_reference_lse(qkv, heads)
    B, N, d = _check_qkv(qkv, heads, "flash_attention_qkv_forward_lse")
    out = torch.empty((B, N, heads * d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B, heads, N, 1), dtype=torch.float32, device=qkv.device)
    lib = _cuda.library()
    with torch.cuda.device(qkv.device):
        code = lib.skt_flash_attention_qkv_lse(
            qkv.data_ptr(),
            out.data_ptr(),
            lse.data_ptr(),
            B,
            N,
            heads,
            d,
            _cuda.DTYPE_CODES[qkv.dtype],
            (1.0 / math.sqrt(d)) * _LOG2E,
            _cuda.stream(),
        )
    _cuda.check(code, "flash_attention_qkv_forward_lse")
    flash_attention_qkv_forward_lse.launches += 1
    return out, lse


flash_attention_qkv_forward_lse.launches = 0


def flash_attention_qkv_backward(
    qkv: torch.Tensor, o: torch.Tensor, lse: torch.Tensor, g: torch.Tensor, heads: int
) -> torch.Tensor:
    """Kernel K5: ``dqkv`` ``(B, N, 3*H*d)`` from the forward's input, output
    and logsumexp and the output gradient ``g``.

    On CPU tensors this is :func:`_qkv_backward_reference`.  On CUDA tensors
    it launches the kernels or raises: qkv as for K2, ``o`` and ``g``
    ``(B, N, H*d)`` of qkv's dtype and contiguous, ``lse`` ``(B, H, N, 1)``
    float32 contiguous.  ``delta = rowsum(g * o)`` is a float32 PyTorch pass
    here, as the JAX package computes it outside its kernels; one call
    launches both kernels (dq, then dk and dv), which write the three thirds
    of one packed output."""
    if qkv.device.type == "cpu":
        return _qkv_backward_reference(qkv, o, lse, g, heads)
    name = "flash_attention_qkv_backward"
    B, N, d = _check_qkv(qkv, heads, name)
    for label, t in (("o", o), ("g", g)):
        if t.shape != (B, N, heads * d) or t.dtype != qkv.dtype or t.device != qkv.device:
            raise ValueError(f"{name}: {label} must be ({B}, {N}, {heads * d}) {qkv.dtype}, got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be contiguous and 16-byte aligned")
    if lse.shape != (B, heads, N, 1) or lse.dtype != torch.float32 or lse.device != qkv.device:
        raise ValueError(f"{name}: lse must be ({B}, {heads}, {N}, 1) float32, got {tuple(lse.shape)} {lse.dtype}")
    if not lse.is_contiguous() or lse.data_ptr() % 16:
        raise ValueError(f"{name}: lse must be contiguous and 16-byte aligned")
    delta = (g.view(B, N, heads, d).float() * o.view(B, N, heads, d).float()).sum(-1).transpose(1, 2).contiguous()
    dqkv = torch.empty_like(qkv)
    lib = _cuda.library()
    with torch.cuda.device(qkv.device):
        code = lib.skt_flash_attention_qkv_backward(
            qkv.data_ptr(),
            g.data_ptr(),
            lse.data_ptr(),
            delta.data_ptr(),
            dqkv.data_ptr(),
            B,
            N,
            heads,
            d,
            _cuda.DTYPE_CODES[qkv.dtype],
            1.0 / math.sqrt(d),
            _cuda.stream(),
        )
    _cuda.check(code, name)
    flash_attention_qkv_backward.launches += 1
    return dqkv


flash_attention_qkv_backward.launches = 0


class _FlashQKV(torch.autograd.Function):
    """K4 forward saving ``(qkv, o, lse)``, K5 backward: the JAX package's
    ``_flash_qkv_vjp``.  The kernels are looked up in this module when they
    run, so a caller may swap them for their plain versions."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, heads: int) -> torch.Tensor:
        o, lse = flash_attention_qkv_forward_lse(qkv, heads)
        ctx.save_for_backward(qkv, o, lse)
        ctx.heads = heads
        return o

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> tuple[torch.Tensor, None]:
        qkv, o, lse = ctx.saved_tensors
        return flash_attention_qkv_backward(qkv, o, lse, g.contiguous(), ctx.heads), None


def flash_attention_qkv(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Fused-qkv attention ``(B, N, 3*H*d) -> (B, N, H*d)`` with its gradient.

    The JAX package's dispatch rule: the kernels where the packed width
    splits into ``heads`` heads of a multiple of 128 and ``N`` is a multiple
    of 128; split + plain attention otherwise.  Where a gradient is wanted
    the forward is K4 and the backward K5; where none is (grad mode off, or
    qkv not requiring grad), the forward is K2 and nothing is saved."""
    _B, N, D3 = qkv.shape
    if D3 % (3 * heads) or (D3 // 3 // heads) % _LANE or N % _LANE:
        return _qkv_reference(qkv, heads)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FlashQKV.apply(qkv, heads)
    return flash_attention_qkv_forward(qkv, heads)


# ---- B10: d = 64 attention on packed, possibly strided q, k, v -----------------------

_PAIRS_D = 64


def pairs_kernel_fits(N: int, heads: int, d: int) -> bool:
    """Shapes B10 takes: head dim 64, at any ``N`` and any head count.  The
    JAX package's even-heads, ``N % 128`` and VMEM-budget conditions are TPU
    lane and memory rules: B10 runs one head a block and masks a ragged
    last tile."""
    return d == _PAIRS_D


class _StridedArgs(ctypes.Structure):
    "``StridedArgs`` of ``csrc/flash_attention.cu``: element strides (batch, head, row) of q, k, v, out."

    _fields_ = [  # noqa: RUF012 — ctypes layout declaration
        ("q", ctypes.c_void_p),
        ("k", ctypes.c_void_p),
        ("v", ctypes.c_void_p),
        ("o", ctypes.c_void_p),
        ("q_strides", ctypes.c_longlong * 3),
        ("k_strides", ctypes.c_longlong * 3),
        ("v_strides", ctypes.c_longlong * 3),
        ("o_strides", ctypes.c_longlong * 3),
        ("B", ctypes.c_int),
        ("N", ctypes.c_int),
        ("H", ctypes.c_int),
        ("d", ctypes.c_int),
        ("scale_log2", ctypes.c_float),
    ]


def _head_strides(x: torch.Tensor, d: int) -> tuple[int, int, int]:
    "(batch, head, row) element strides of a packed (B, N, H*d) tensor or view."
    return x.stride(0), d * x.stride(2), x.stride(1)


def flash_attention_pairs_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Kernel B10: ``(B, N, H*64)`` x3 -> ``(B, N, H*64)``, unmasked softmax
    attention per head.

    On CPU tensors this is :func:`_packed_reference`.  On CUDA tensors it
    launches the kernel or raises: bf16 or fp16, all three of one shape,
    head dim 64, any ``B``, ``N`` and head count; each may be a strided view
    (the ``chunk(3)`` thirds of a qkv product) with unit channel stride,
    16-byte aligned base and row and batch strides a multiple of 8 elements.
    The output is a new contiguous tensor."""
    if q.device.type == "cpu":
        return _packed_reference(q, k, v, heads)
    name = "flash_attention_pairs_forward"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.ndim != 3:
        raise ValueError(f"{name}: q must be (B, N, H*d), got {tuple(q.shape)}")
    B, N, D = q.shape
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"{name}: dtype {q.dtype} unsupported on CUDA (bfloat16 or float16)")
    if D % heads or not pairs_kernel_fits(N, heads, D // heads):
        raise ValueError(f"{name}: width {D} over {heads} heads: head dim must be {_PAIRS_D}")
    for label, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {label} must be {tuple(q.shape)} {q.dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.stride(2) != 1 or t.data_ptr() % 16 or t.stride(0) % 8 or t.stride(1) % 8:
            raise ValueError(f"{name}: {label} needs unit channel stride, 16-byte aligned rows and batches")
    out = torch.empty((B, N, D), dtype=q.dtype, device=q.device)
    args = _StridedArgs(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        out.data_ptr(),
        (ctypes.c_longlong * 3)(*_head_strides(q, _PAIRS_D)),
        (ctypes.c_longlong * 3)(*_head_strides(k, _PAIRS_D)),
        (ctypes.c_longlong * 3)(*_head_strides(v, _PAIRS_D)),
        (ctypes.c_longlong * 3)(*_head_strides(out, _PAIRS_D)),
        B,
        N,
        heads,
        _PAIRS_D,
        (1.0 / math.sqrt(_PAIRS_D)) * _LOG2E,
    )
    lib = _cuda.library()
    with torch.cuda.device(q.device):
        code = lib.skt_flash_attention_strided(
            ctypes.byref(args), ctypes.sizeof(args), _cuda.DTYPE_CODES[q.dtype], _cuda.stream()
        )
    _cuda.check(code, name)
    flash_attention_pairs_forward.launches += 1
    return out


flash_attention_pairs_forward.launches = 0


class _FlashPairs(torch.autograd.Function):
    """B10 forward, the plain version's gradient backward: the JAX package's
    ``_flash_pairs_vjp``.  The kernel is looked up in this module when it
    runs, so a caller may swap it for its plain version."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
        ctx.save_for_backward(q, k, v)
        ctx.heads = heads
        return flash_attention_pairs_forward(q, k, v, heads)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = _packed_reference(*inputs, ctx.heads)
        grads = torch.autograd.grad(out, inputs, g)
        return *(gr if need else None for gr, need in zip(grads, ctx.needs_input_grad)), None


def flash_attention_pairs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """d = 64 packed attention ``(B, N, H*64)`` x3 -> ``(B, N, H*64)`` with its
    gradient: B10 forward, the plain version's gradient backward where one is
    wanted.  On CPU tensors the plain version; on CUDA tensors every shape
    goes to the kernel, which raises on what it cannot take."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashPairs.apply(q, k, v, heads)
    return flash_attention_pairs_forward(q, k, v, heads)
