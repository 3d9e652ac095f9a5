"""Attention straight off the fused qkv projection, with its gradient.

:func:`flash_attention_qkv_forward` launches the hand-written kernel K2
(``csrc/flash_attention_sm90.cu``): it reads each head's q, k and v in place
from the packed ``(B, N, 3*H*d)`` output of the qkv matmul and writes the
packed ``(B, N, H*d)`` layout, with the score matrix never leaving registers.
:func:`flash_attention_qkv_forward_lse` (K4, the same kernel body) also
writes each row's logsumexp, and :func:`flash_attention_qkv_backward` (K5,
``csrc/flash_attention_bwd.cu``: a dq and a dkv kernel on the same Hopper
primitives, in the geometry of :func:`attention_backward_plan`) recomputes
the probabilities from it to give the gradient in the packed qkv layout.
:func:`flash_attention_qkv` ties them into a
:class:`torch.autograd.Function`, as the JAX package's
``custom_vjp`` does.  :func:`flash_attention_pairs_forward` launches B10
(the same kernel body behind a strided entry point, head dim 64) on three
packed ``(B, N, H*64)`` tensors that may be strided views, such as the
``chunk(3)`` thirds of a fused qkv product, and B9 is the same entry point
at head dim 128 too: :func:`flash_attention_forward` on ``(B, H, N, d)``
(a head dim up to 128, zero-padded to an instance) and
:func:`flash_attention_packed_forward` on packed ``(B, N, H*128)``.
K2, K4, B9, B10 and B11 run one Hopper body (TMA, ``wgmma``, a producer warp
and ping-ponged consumer warpgroups) in the geometry :func:`attention_plan`
picks from ``(N, d)`` alone; each wrapper counts its launches by route
(``.routes``).  :func:`flash_attention_block_stats` launches B11: one K/V
block's attention with the row max and sum that :func:`softmax_merge` folds
across blocks (a ring attention hop), at separate query and key counts.
:func:`flash_attention_pairs`, :func:`flash_attention` and
:func:`flash_attention_packed` are their autograd dispatches, with the plain
version's gradient backward.  The
plain versions beside each kernel (:func:`attention_reference`,
:func:`_packed_reference`, :func:`_qkv_reference`,
:func:`_qkv_reference_lse`, :func:`_qkv_backward_reference`,
:func:`_block_stats_reference`) are the CPU path and the kernels' oracles.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from . import _cuda

_LANE = 128
_LOG2E = 1.4426950408889634

# ---- the Hopper body's plan: its geometry, chosen from (N, d) alone --------------------------------

_BLOCK_K = 128  # keys a K/V tile (csrc/flash_attention_sm90.cu kBlockK): fixes the order of each row's sums
_SWIZZLE_ATOM = 1024  # the shared memory's alignment slack


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """The geometry of K2, K4, B9 and B10 on the Hopper body for ``N`` rows at head dim ``d``: a block
    takes ``block_q`` query rows (two consumer warpgroups of 64) of one (batch item, head) and streams
    the keys in tiles of ``block_k`` through a ring of ``stages`` K/V stages; ``smem`` is the block's
    shared memory (``csrc/flash_attention_sm90.cu`` ``smem_bytes``), which the C entry points check."""

    block_q: int
    block_k: int
    stages: int
    smem: int


@functools.lru_cache(maxsize=256)
def attention_plan(N: int, d: int) -> AttentionPlan:
    """K2's, K4's, B9's and B10's plan for ``N`` query (and key) rows at head dim ``d`` (64 or 128).

    It never reads the batch or the head count, and a row's arithmetic depends only on ``block_k``: an
    item's bits are the same alone or packed.  Two consumer warpgroups (128 query rows) a block at every
    N, the DiT's 1024 rows included: one warpgroup's 64-row blocks measured 1.1-1.6x slower at every
    served shape.  Two K/V stages (at d = 128, Q 32 KB + 2 x 64 KB): three or four measured no faster
    at any served shape, and three slower at Flux's (``scripts/bench_attention_kernels.py --vary``,
    PERF.md)."""
    if d not in (64, 128):
        raise ValueError(f"attention_plan: head dim {d} has no instance (64 or 128)")
    if N < 1:
        raise ValueError(f"attention_plan: N = {N}")
    block_q, stages = 128, 2
    smem = (block_q + 2 * stages * _BLOCK_K) * d * 2 + (1 + 4 * stages) * 8 + _SWIZZLE_ATOM
    return AttentionPlan(block_q, _BLOCK_K, stages, smem)


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """The geometry of K5's two kernels (``csrc/flash_attention_bwd.cu``) for ``N`` rows at head dim 128.
    The dq kernel's block takes ``block`` query rows (two consumer warpgroups of 64) of one (batch item,
    head) and streams the keys in tiles of ``key_tile`` through ``dq_stages`` K/V stages; the dkv kernel's
    block takes ``block`` keys and streams the queries in tiles of ``query_tile`` (with their lse and
    delta) through ``dkv_stages`` Q/dO stages.  Each kernel's grid is ``(blocks, H, B)``; ``dq_smem`` and
    ``dkv_smem`` are their blocks' shared memory (``dq_smem`` and ``dkv_smem`` in the source), which the
    C entry point checks."""

    block: int
    key_tile: int
    query_tile: int
    dq_stages: int
    dkv_stages: int
    blocks: int
    dq_smem: int
    dkv_smem: int


@functools.lru_cache(maxsize=256)
def attention_backward_plan(N: int, d: int) -> BackwardPlan:
    """K5's plan for ``N`` query (and key) rows at head dim ``d`` (128 only).

    It never reads the batch or the head count, and every output's sums run in the order of one tile
    (``key_tile`` for dq, ``query_tile`` for dk and dv): a gradient's bits are the same for an item alone
    or packed.  The dkv kernel's 64-query tiles keep a consumer warpgroup's dK and dV (128 registers) and
    its S^T and dP^T (64) under setmaxnreg's 240; a 128-query tile would not fit.  Two stages in each
    ring: the dq kernel's fits no third, and 2, 3 and 4 Q/dO stages took the dkv kernel the same time
    (``scripts/bench_attention_kernels.py --vary dkv_stages=2,3,4``, PERF.md)."""
    if d != 128:
        raise ValueError(f"attention_backward_plan: head dim {d} has no instance (128)")
    if N < 1:
        raise ValueError(f"attention_backward_plan: N = {N}")
    block, key_tile, query_tile = 128, _BLOCK_K, 64
    dq_stages, dkv_stages = 2, 2

    def tile(rows: int) -> int:
        return rows * d * 2

    dq_smem = 2 * tile(block) + 2 * dq_stages * tile(key_tile) + (1 + 2 * dq_stages) * 8 + _SWIZZLE_ATOM
    dkv_smem = (
        2 * tile(block) + 2 * dkv_stages * tile(query_tile) + dkv_stages * 2 * query_tile * 4
        + (1 + 2 * dkv_stages) * 8 + _SWIZZLE_ATOM
    )
    return BackwardPlan(block, key_tile, query_tile, dq_stages, dkv_stages, -(-N // block), dq_smem, dkv_smem)


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
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{name}: qkv must be contiguous and 16-byte aligned")
    return B, N, d


def flash_attention_qkv_forward(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Kernel K2: ``(B, N, 3*H*d) -> (B, N, H*d)``, unmasked softmax attention.

    On CPU tensors this is :func:`_qkv_reference`.  On CUDA tensors it
    launches the kernel or raises: bf16 or fp16 (an f32 qkv has no tensor-
    core path in this kernel), contiguous, head dim 128, any ``N`` (a ragged
    last tile is masked)."""
    if qkv.device.type == "cpu":
        return _qkv_reference(qkv, heads)
    B, N, d = _check_qkv(qkv, heads, "flash_attention_qkv_forward")
    out = torch.empty((B, N, heads * d), dtype=qkv.dtype, device=qkv.device)
    plan = attention_plan(N, d)
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
            plan.block_q,
            plan.stages,
            _cuda.stream(),
        )
    _cuda.check(code, "flash_attention_qkv_forward")
    flash_attention_qkv_forward.launches += 1
    flash_attention_qkv_forward.routes["wgmma"] += 1
    return out


flash_attention_qkv_forward.launches = 0
flash_attention_qkv_forward.routes = {"wgmma": 0}  # launches by route: the Hopper body is the only one


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
    plan = attention_plan(N, d)
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
            plan.block_q,
            plan.stages,
            _cuda.stream(),
        )
    _cuda.check(code, "flash_attention_qkv_forward_lse")
    flash_attention_qkv_forward_lse.launches += 1
    flash_attention_qkv_forward_lse.routes["wgmma"] += 1
    return out, lse


flash_attention_qkv_forward_lse.launches = 0
flash_attention_qkv_forward_lse.routes = {"wgmma": 0}


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
    launches both kernels (dq, then dk and dv) in the geometry of
    :func:`attention_backward_plan`, which write the three thirds of one
    packed output."""
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
    # f32 products of 16-bit values are exact: o is cast inside the product's kernel, not in a pass of its own
    delta = (g.float() * o).view(B, N, heads, d).sum(-1).transpose(1, 2).contiguous()
    dqkv = torch.empty_like(qkv)
    plan = attention_backward_plan(N, d)
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
            plan.block,
            plan.dq_stages,
            plan.query_tile,
            plan.dkv_stages,
            _cuda.stream(),
        )
    _cuda.check(code, name)
    flash_attention_qkv_backward.launches += 1
    flash_attention_qkv_backward.routes["wgmma"] += 1
    return dqkv


flash_attention_qkv_backward.launches = 0
flash_attention_qkv_backward.routes = {"wgmma": 0}


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

    The JAX package's dispatch rule on the head dim: the kernels where the
    packed width splits into ``heads`` heads of a multiple of 128, split +
    plain attention otherwise.  Its ``N % 128`` rule is a TPU tiling one: on
    a CUDA tensor every ``N`` goes to the kernels (which mask a ragged last
    tile); on a CPU tensor, where every path is a plain version, it stays.
    Where a gradient is wanted the forward is K4 and the backward K5; where
    none is (grad mode off, or qkv not requiring grad), the forward is K2 and
    nothing is saved."""
    _B, N, D3 = qkv.shape
    if D3 % (3 * heads) or (D3 // 3 // heads) % _LANE or (not qkv.is_cuda and N % _LANE):
        return _qkv_reference(qkv, heads)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FlashQKV.apply(qkv, heads)
    return flash_attention_qkv_forward(qkv, heads)


# ---- B10 and B9: attention on q, k, v at any strides (skt_flash_attention_strided) ---------

_PAIRS_D = 64
_STRIDED_D = (64, 128)  # the head dims the strided kernel is built for


def pairs_kernel_fits(N: int, heads: int, d: int) -> bool:
    """Shapes B10 takes: head dim 64, at any ``N`` and any head count.  The
    JAX package's even-heads, ``N % 128`` and VMEM-budget conditions are TPU
    lane and memory rules: B10 runs one head a block and masks a ragged
    last tile."""
    return d == _PAIRS_D


class _StridedArgs(ctypes.Structure):
    """``StridedArgs`` of ``csrc/flash_attention_sm90.cu``: element strides (batch, head, row) of q, k, v,
    out, and the plan."""

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
        ("block_q", ctypes.c_int),
        ("stages", ctypes.c_int),
    ]


def _head_strides(x: torch.Tensor, d: int) -> tuple[int, int, int]:
    "(batch, head, row) element strides of a packed (B, N, H*d) tensor or view."
    return x.stride(0), d * x.stride(2), x.stride(1)


def _check_strided(
    name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ndim: int, kv_shape: torch.Size | None = None
) -> None:
    """What the strided entry points take of q, k and v (k and v of ``kv_shape``, q's shape by
    default); raises on anything else."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.ndim != ndim:
        raise ValueError(f"{name}: q must have {ndim} dimensions, got {tuple(q.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"{name}: dtype {q.dtype} unsupported on CUDA (bfloat16 or float16)")
    shapes = {"q": q.shape, "k": kv_shape or q.shape, "v": kv_shape or q.shape}
    for label, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != shapes[label] or t.dtype != q.dtype or t.device != q.device:
            want = tuple(shapes[label])
            raise ValueError(f"{name}: {label} must be {want} {q.dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(t.stride(i) % 8 for i in range(ndim - 1)):
            raise ValueError(f"{name}: {label} needs unit channel stride, 16-byte aligned rows, heads and batches")


def _launch_strided(
    name: str,
    views: tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
    strides: tuple[tuple[int, int, int], ...],
    B: int,
    N: int,
    H: int,
    d_kernel: int,
    scale: float,
) -> None:
    "One launch of ``skt_flash_attention_strided`` on q, k, v, out with their (batch, head, row) strides."
    q, k, v, o = views
    plan = attention_plan(N, d_kernel)
    args = _StridedArgs(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        o.data_ptr(),
        *((ctypes.c_longlong * 3)(*st) for st in strides),
        B,
        N,
        H,
        d_kernel,
        scale * _LOG2E,
        plan.block_q,
        plan.stages,
    )
    lib = _cuda.library()
    with torch.cuda.device(q.device):
        code = lib.skt_flash_attention_strided(
            ctypes.byref(args), ctypes.sizeof(args), _cuda.DTYPE_CODES[q.dtype], _cuda.stream()
        )
    _cuda.check(code, name)


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
    _check_strided(name, q, k, v, 3)
    B, N, D = q.shape
    if D % heads or not pairs_kernel_fits(N, heads, D // heads):
        raise ValueError(f"{name}: width {D} over {heads} heads: head dim must be {_PAIRS_D}")
    out = torch.empty((B, N, D), dtype=q.dtype, device=q.device)
    views = (q, k, v, out)
    strides = tuple(_head_strides(t, _PAIRS_D) for t in views)
    _launch_strided(name, views, strides, B, N, heads, _PAIRS_D, 1.0 / math.sqrt(_PAIRS_D))
    flash_attention_pairs_forward.launches += 1
    flash_attention_pairs_forward.routes["wgmma"] += 1
    return out


flash_attention_pairs_forward.launches = 0
flash_attention_pairs_forward.routes = {"wgmma": 0}


class _PlainBackward(torch.autograd.Function):
    """A kernel's forward, the plain version's gradient backward: the JAX
    package's ``_flash_pairs_vjp``, ``_flash_packed_vjp`` and ``_flash_vjp``.
    ``kernel`` and ``plain`` are names in this module, looked up when they
    run, so a caller may swap the kernel for its plain version."""

    @staticmethod
    def forward(ctx, kernel: str, plain: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *extra):
        ctx.save_for_backward(q, k, v)
        ctx.plain, ctx.extra = plain, extra
        return globals()[kernel](q, k, v, *extra)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = globals()[ctx.plain](*inputs, *ctx.extra)
        grads = torch.autograd.grad(out, inputs, g)
        needs = ctx.needs_input_grad[2:5]
        return None, None, *(gr if need else None for gr, need in zip(grads, needs)), *([None] * len(ctx.extra))


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention_pairs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """d = 64 packed attention ``(B, N, H*64)`` x3 -> ``(B, N, H*64)`` with its
    gradient: B10 forward, the plain version's gradient backward where one is
    wanted.  On CPU tensors the plain version; on CUDA tensors every shape
    goes to the kernel, which raises on what it cannot take."""
    if _wants_grad(q, k, v):
        return _PlainBackward.apply("flash_attention_pairs_forward", "_packed_reference", q, k, v, heads)
    return flash_attention_pairs_forward(q, k, v, heads)


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel B9 on ``(B, H, N, d)`` x3 -> ``(B, H, N, d)``: unmasked softmax
    attention per (batch item, head).

    On CPU tensors this is :func:`attention_reference`.  On CUDA tensors it
    launches the strided kernel or raises: bf16 or fp16, all three of one
    shape, any strides with a unit last stride whose others are multiples of
    8 elements, any ``B``, ``H`` and ``N``, and ``d <= 128`` with ``d % 8 ==
    0``.  At d = 64 and 128 the kernel reads q, k and v in place (views of a
    qkv product need no copy); another d is zero-padded to the next of the
    two, which is exact (the zero lanes add nothing to a score and their
    output lanes are sliced away) with the true ``1/sqrt(d)`` scale.  The
    result is a ``(B, H, N, d)`` view of a ``(B, N, H, d)`` tensor, so the
    heads merge back into a packed ``(B, N, H*d)`` without a copy."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    name = "flash_attention_forward"
    if q.ndim != 4:
        raise ValueError(f"{name}: q must be (B, H, N, d), got {tuple(q.shape)}")
    B, H, N, d = q.shape
    if d > _STRIDED_D[1] or d % 8:
        raise ValueError(f"{name}: head dim {d} unsupported (d <= 128, a multiple of 8)")
    d_kernel = _STRIDED_D[0] if d <= _STRIDED_D[0] else _STRIDED_D[1]
    if d != d_kernel:
        q, k, v = (torch.nn.functional.pad(t, (0, d_kernel - d)) for t in (q, k, v))
    _check_strided(name, q, k, v, 4)
    out = torch.empty((B, N, H, d_kernel), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    views = (q, k, v, out)
    strides = tuple((t.stride(0), t.stride(1), t.stride(2)) for t in views)
    _launch_strided(name, views, strides, B, N, H, d_kernel, 1.0 / math.sqrt(d))
    flash_attention_forward.launches += 1
    flash_attention_forward.routes["wgmma"] += 1
    return out if d == d_kernel else out[..., :d]


flash_attention_forward.launches = 0
flash_attention_forward.routes = {"wgmma": 0}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention on ``(B, H, N, d)`` with its gradient: B9 forward, the plain
    version's gradient backward where one is wanted (the JAX package's
    ``flash_attention``, whose backward is the einsum's vjp).  The JAX
    package's ``N % 128`` rule stays on the CPU, where both paths are plain
    versions; on a CUDA tensor every shape goes to the kernel, which raises
    on what it cannot take."""
    if not q.is_cuda and q.shape[2] % _LANE:
        return attention_reference(q, k, v)
    if _wants_grad(q, k, v):
        return _PlainBackward.apply("flash_attention_forward", "attention_reference", q, k, v)
    return flash_attention_forward(q, k, v)


def flash_attention_packed_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Kernel B9 on the packed layout: ``(B, N, H*d)`` x3 -> ``(B, N, H*d)``
    at ``d = 128``, each head's q, k and v read in place at its feature
    offset (the strided kernel at packed strides).

    On CPU tensors this is :func:`_packed_reference`.  On CUDA tensors it
    launches the kernel or raises: bf16 or fp16, all three of one shape,
    ``d = 128`` (the JAX package's ``d % 128 == 0``; ``d > 128`` has no
    instance), any ``B``, ``N`` and head count, strided views as
    :func:`flash_attention_pairs_forward` takes them.  The JAX package's
    ``N % 128`` and block pickers are TPU rules and are dropped."""
    if q.device.type == "cpu":
        return _packed_reference(q, k, v, heads)
    name = "flash_attention_packed_forward"
    _check_strided(name, q, k, v, 3)
    B, N, D = q.shape
    d = D // heads
    if D % heads or d != _STRIDED_D[1]:
        raise ValueError(f"{name}: width {D} over {heads} heads: head dim must be {_STRIDED_D[1]}")
    out = torch.empty((B, N, D), dtype=q.dtype, device=q.device)
    views = (q, k, v, out)
    strides = tuple(_head_strides(t, d) for t in views)
    _launch_strided(name, views, strides, B, N, heads, d, 1.0 / math.sqrt(d))
    flash_attention_packed_forward.launches += 1
    flash_attention_packed_forward.routes["wgmma"] += 1
    return out


flash_attention_packed_forward.launches = 0
flash_attention_packed_forward.routes = {"wgmma": 0}


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Packed-layout attention ``(B, N, H*d)`` x3 -> ``(B, N, H*d)`` with its
    gradient: B9 forward, the plain version's gradient backward where one is
    wanted.  The JAX package's dispatch: the plain version where the width
    does not split into heads of a multiple of 128 (and, on the CPU, where
    ``N % 128``); the kernel otherwise."""
    _B, N, D = q.shape
    if D % heads or (D // heads) % _LANE or (not q.is_cuda and N % _LANE):
        return _packed_reference(q, k, v, heads)
    if _wants_grad(q, k, v):
        return _PlainBackward.apply("flash_attention_packed_forward", "_packed_reference", q, k, v, heads)
    return flash_attention_packed_forward(q, k, v, heads)


# ---- B11: one K/V block's attention and row statistics (skt_flash_attention_block_stats) ----


def _block_stats_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain one-block attention with its row statistics: B11's oracle and CPU path.

    The JAX package's order (both branches of its ``flash_attention_block_stats``): float32
    scores times ``1/sqrt(d)``, the row max ``m``, ``p = exp(s - m)``, ``l = sum(p)``, ``p / l``
    rounded to v's dtype, the value product in float32, the output rounded to q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.matmul((p / l[..., None]).to(v.dtype).float(), v.float())
    return o.to(q.dtype), m, l


class _BlockStatsArgs(ctypes.Structure):
    """``BlockStatsArgs`` of ``csrc/flash_attention_sm90.cu``: element strides (batch, head, row) of q, k, v,
    out, and the plan."""

    _fields_ = [  # noqa: RUF012 — ctypes layout declaration
        ("q", ctypes.c_void_p),
        ("k", ctypes.c_void_p),
        ("v", ctypes.c_void_p),
        ("o", ctypes.c_void_p),
        ("m", ctypes.c_void_p),
        ("l", ctypes.c_void_p),
        ("q_strides", ctypes.c_longlong * 3),
        ("k_strides", ctypes.c_longlong * 3),
        ("v_strides", ctypes.c_longlong * 3),
        ("o_strides", ctypes.c_longlong * 3),
        ("B", ctypes.c_int),
        ("H", ctypes.c_int),
        ("Nq", ctypes.c_int),
        ("Nk", ctypes.c_int),
        ("d", ctypes.c_int),
        ("scale_log2", ctypes.c_float),
        ("block_q", ctypes.c_int),
        ("stages", ctypes.c_int),
    ]


def _block_stats_args(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, m: torch.Tensor, l: torch.Tensor, d: int
) -> _BlockStatsArgs:
    """B11's arguments for ``(B, H, Nq, d_kernel)`` q and o and ``(B, H, Nk, d_kernel)`` k and v: the query
    count sizes the grid and the Q map, the key count the K/V maps and the key loop; the plan is
    :func:`attention_plan` at ``Nq``; the scale is the true head dim ``d``'s."""
    B, H, Nq, d_kernel = q.shape
    plan = attention_plan(Nq, d_kernel)
    return _BlockStatsArgs(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        o.data_ptr(),
        m.data_ptr(),
        l.data_ptr(),
        *((ctypes.c_longlong * 3)(t.stride(0), t.stride(1), t.stride(2)) for t in (q, k, v, o)),
        B,
        H,
        Nq,
        k.shape[2],
        d_kernel,
        (1.0 / math.sqrt(d)) * _LOG2E,
        plan.block_q,
        plan.stages,
    )


def flash_attention_block_stats(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B11: one K/V block's attention and the row statistics that fold blocks together.

    ``q`` ``(B, H, Nq, d)``, ``k`` and ``v`` ``(B, H, Nk, d)`` -> ``(o, m, l)``: ``o =
    softmax(q kᵀ / sqrt(d)) v`` normalised within the block, ``(B, H, Nq, d)`` in q's dtype;
    ``m`` the row max of the scaled scores (natural-log units) and ``l`` the row sum of
    ``exp(s - m)``, both ``(B, H, Nq)`` float32 contiguous.  :func:`softmax_merge` folds a
    sequence of such results into exact attention over every block: the inner op of ring
    attention (``parallel/ring_attention.py``).

    On CPU tensors this is :func:`_block_stats_reference`.  On CUDA tensors it launches the
    kernel or raises: bf16 or fp16, any ``B``, ``H``, ``Nq``, ``Nk`` (ragged tiles masked), q,
    k and v at any strides as :func:`flash_attention_forward` takes them, ``d <= 128`` with ``d
    % 8 == 0`` (64 and 128 read in place, another d zero-padded to the next, with the true
    ``1/sqrt(d)``).  The JAX package's ``Nq % block_q``, ``Nk % 128`` gates and their quiet
    einsum branch are TPU tiling rules and are dropped; its 128-lane broadcast of ``m`` and
    ``l`` is a TPU layout and is not carried over."""
    if q.device.type == "cpu":
        return _block_stats_reference(q, k, v)
    name = "flash_attention_block_stats"
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"{name}: q and k must be (B, H, N, d), got {tuple(q.shape)} and {tuple(k.shape)}")
    B, H, Nq, d = q.shape
    Nk = k.shape[2]
    if d > _STRIDED_D[1] or d % 8:
        raise ValueError(f"{name}: head dim {d} unsupported (d <= 128, a multiple of 8)")
    d_kernel = _STRIDED_D[0] if d <= _STRIDED_D[0] else _STRIDED_D[1]
    if d != d_kernel:
        q, k, v = (torch.nn.functional.pad(t, (0, d_kernel - d)) for t in (q, k, v))
    _check_strided(name, q, k, v, 4, torch.Size((B, H, Nk, d_kernel)))
    o = torch.empty((B, H, Nq, d_kernel), dtype=q.dtype, device=q.device)
    m = torch.empty((B, H, Nq), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H, Nq), dtype=torch.float32, device=q.device)
    args = _block_stats_args(q, k, v, o, m, l, d)
    lib = _cuda.library()
    with torch.cuda.device(q.device):
        code = lib.skt_flash_attention_block_stats(
            ctypes.byref(args), ctypes.sizeof(args), _cuda.DTYPE_CODES[q.dtype], _cuda.stream()
        )
    _cuda.check(code, name)
    flash_attention_block_stats.launches += 1
    flash_attention_block_stats.routes["wgmma"] += 1
    return (o if d == d_kernel else o[..., :d]), m, l


flash_attention_block_stats.launches = 0
flash_attention_block_stats.routes = {"wgmma": 0}


class _BlockStatsBackward(torch.autograd.Function):
    """B11's forward, the plain version's gradient backward: the JAX package has no backward kernel
    for ``flash_attention_block_stats`` and differentiates the kernel itself; here the backward
    recomputes :func:`_block_stats_reference` under autograd and takes the gradient of all three
    outputs (``softmax_merge`` reads o, m and l).  The kernel is looked up by name when it runs."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        ctx.save_for_backward(q, k, v)
        o, m, l = globals()["flash_attention_block_stats"](q, k, v)
        return o, m, l

    @staticmethod
    def backward(ctx, go: torch.Tensor, gm: torch.Tensor, gl: torch.Tensor):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = _block_stats_reference(*inputs)
        return torch.autograd.grad(outs, inputs, (go, gm, gl))


def flash_attention_block_stats_grad(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_block_stats` with its gradient: kernel B11 forward, the plain
    version's gradient backward (ring attention's block op under autograd)."""
    return _BlockStatsBackward.apply(q, k, v)


def softmax_merge(
    state: tuple[torch.Tensor, torch.Tensor, torch.Tensor], block: tuple[torch.Tensor, torch.Tensor, torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold one ``(o, m, l)`` block result into a running ``(acc, peak, total)`` state (acc
    unnormalised float32); after every block, the exact attention is ``acc / total[..., None]``.
    Plain float32 PyTorch, as the JAX package computes it outside its kernels."""
    acc, peak, total = state
    o_blk, m_blk, l_blk = block
    peak_next = torch.maximum(peak, m_blk)
    r_old = torch.exp(peak - peak_next)
    r_new = torch.exp(m_blk - peak_next)
    total_next = total * r_old + l_blk * r_new
    acc_next = acc * r_old[..., None] + o_blk.float() * (l_blk * r_new)[..., None]
    return acc_next, peak_next, total_next
