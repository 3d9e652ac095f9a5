"""Per-head RMS qk-norm and rotary embedding on a packed qkv tensor.

Flux-class blocks RMS-normalise and rotate the q and k thirds of the fused
qkv projection (consecutive-pair rotation, as diffusers'
``FluxTransformer2DModel``).  :func:`rope_qk_norm_reference` is the plain
PyTorch version (the CPU path, the kernel's oracle and the backward);
:func:`rope_qk_norm_forward` launches the hand-written kernel B7
(``csrc/rope.cu``): one read and one write of the q/k thirds, the v third
left alone when it writes in place.  :func:`fused_rope_qk_norm` is the
dispatch a model calls, with the JAX package's custom VJP: the forward is
the kernel, the backward differentiates the plain version (the TPU has no
backward kernel here, and neither has the port).
"""

from __future__ import annotations

import torch

from . import _cuda

_INSTANCES = (128, 64)  # the head dims B7 has an instance for; any other even d takes its run-time-d body
_DTYPES = (torch.float32, torch.bfloat16)
_EPS = 1e-6


def rope_qk_norm_reference(
    qkv: torch.Tensor,
    q_gain: torch.Tensor,
    k_gain: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    heads: int,
    eps: float = _EPS,
) -> torch.Tensor:
    """Plain version: ``qkv`` (B, N, 3*heads*d) laid out ``[q | k | v]``,
    ``cos``/``sin`` (N, d // 2) per-pair tables, ``q_gain``/``k_gain`` (d,)
    RMS gains; returns a new tensor of qkv's shape and dtype.

    The JAX package's ``rope_qk_norm_reference``, operation for operation:
    statistics and rotation in float32, one rounding to qkv's dtype."""
    B, N, D3 = qkv.shape
    d = D3 // 3 // heads
    h = qkv.reshape(B, N, 3, heads, d)
    co = cos[None, :, None, :]
    si = sin[None, :, None, :]

    def prep(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps) * g
        pairs = y.reshape(B, N, heads, d // 2, 2)
        y0, y1 = pairs[..., 0], pairs[..., 1]
        out = torch.stack([y0 * co - y1 * si, y0 * si + y1 * co], dim=-1)
        return out.reshape(x.shape).to(x.dtype)

    h = torch.stack([prep(h[:, :, 0], q_gain), prep(h[:, :, 1], k_gain), h[:, :, 2]], dim=2)
    return h.reshape(B, N, D3)


def _route(d: int) -> str:
    "The launch's route by head dim: its instance, or the run-time-d body."
    return f"d{d}" if d in _INSTANCES else "run-time d"


def rope_qk_norm_forward(
    qkv: torch.Tensor,
    q_gain: torch.Tensor,
    k_gain: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    heads: int,
    eps: float = _EPS,
    in_place: bool = False,
) -> torch.Tensor:
    """Kernel B7, the contract of :func:`rope_qk_norm_reference`.

    On CPU tensors this is the plain version (a new tensor).  On CUDA tensors
    it launches the kernel or raises: qkv float32 or bfloat16, contiguous,
    any even head dim ``d = D3 // (3 * heads)`` (128 and 64 have their own
    instances, every other even d the run-time-d body), any ``B`` and ``N``;
    the gains (d,) float32 contiguous; the tables (N, d/2) float32 rows of
    unit column stride at any row stride, even at d = 64 and 128 (a row
    range of larger tables is taken as a view).  With ``in_place`` the kernel rewrites the q/k
    thirds of ``qkv`` and returns it; otherwise it writes a new tensor and
    copies v into it.  ``.routes`` counts the launches by head-dim route."""
    if qkv.device.type == "cpu":
        return rope_qk_norm_reference(qkv, q_gain, k_gain, cos, sin, heads, eps)
    name = "rope_qk_norm_forward"
    if qkv.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {qkv.device}")
    if qkv.ndim != 3 or qkv.dtype not in _DTYPES:
        raise ValueError(f"{name}: qkv must be (B, N, 3*H*d) float32/bfloat16, got {tuple(qkv.shape)} {qkv.dtype}")
    B, N, D3 = qkv.shape
    d = D3 // (3 * heads)
    if D3 != 3 * heads * d or d % 2 or d < 2:
        raise ValueError(f"{name}: packed width {D3} over {heads} heads: the head dim must be a whole even number")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{name}: qkv must be contiguous and 16-byte aligned")
    for label, g in (("q_gain", q_gain), ("k_gain", k_gain)):
        if g.shape != (d,) or g.dtype != torch.float32 or g.device != qkv.device or not g.is_contiguous():
            raise ValueError(f"{name}: {label} must be ({d},) float32 contiguous on {qkv.device}, got {tuple(g.shape)}")
        if g.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")
    stride = cos.stride(0)
    paired = d in _INSTANCES  # an instance reads the tables two columns at a time; the run-time-d body one
    for label, t in (("cos", cos), ("sin", sin)):
        if t.shape != (N, d // 2) or t.dtype != torch.float32 or t.device != qkv.device:
            raise ValueError(f"{name}: {label} must be ({N}, {d // 2}) float32 on {qkv.device}, got {tuple(t.shape)}")
        if t.stride(1) != 1 or t.stride(0) != stride or (paired and (stride % 2 or t.data_ptr() % 8)):
            raise ValueError(
                f"{name}: cos and sin must share a row stride (even at d 64 and 128, 8-byte aligned) and unit columns"
            )
    out = qkv if in_place else torch.empty_like(qkv)
    lib = _cuda.library()
    with torch.cuda.device(qkv.device):
        code = lib.skt_rope_qk_norm(
            qkv.data_ptr(),
            out.data_ptr(),
            cos.data_ptr(),
            sin.data_ptr(),
            stride,
            q_gain.data_ptr(),
            k_gain.data_ptr(),
            B,
            N,
            heads,
            d,
            _cuda.DTYPE_CODES[qkv.dtype],
            eps,
            _cuda.stream(),
        )
    _cuda.check(code, name)
    rope_qk_norm_forward.launches += 1
    rope_qk_norm_forward.routes[_route(d)] += 1
    return out


rope_qk_norm_forward.launches = 0
rope_qk_norm_forward.routes = {"d128": 0, "d64": 0, "run-time d": 0}


class _RopeQKNorm(torch.autograd.Function):
    """B7 forward into a new tensor, the plain version's gradient backward:
    the JAX package's ``_rope_vjp``.  The kernel is looked up in this module
    when it runs, so a caller may swap it for its plain version."""

    @staticmethod
    def forward(ctx, qkv, q_gain, k_gain, cos, sin, heads: int, eps: float) -> torch.Tensor:
        ctx.save_for_backward(qkv, q_gain, k_gain, cos, sin)
        ctx.heads, ctx.eps = heads, eps
        return rope_qk_norm_forward(qkv, q_gain, k_gain, cos, sin, heads, eps)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        qkv, q_gain, k_gain, cos, sin = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(True) for t in (qkv, q_gain, k_gain)]
        with torch.enable_grad():
            out = rope_qk_norm_reference(*inputs, cos, sin, ctx.heads, ctx.eps)
        grads = torch.autograd.grad(out, inputs, g)
        return *(gr if need else None for gr, need in zip(grads, ctx.needs_input_grad)), None, None, None, None


def fused_rope_qk_norm(
    qkv: torch.Tensor,
    q_gain: torch.Tensor,
    k_gain: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    heads: int,
    eps: float = _EPS,
) -> torch.Tensor:
    """RMS qk-norm + RoPE over the q/k thirds of a fused qkv tensor.

    Where a gradient is wanted the forward is B7 into a new tensor and the
    backward the plain version's exact gradient; where none is, B7 rewrites
    ``qkv`` in place.  On CPU tensors both are the plain version (a new
    tensor); on CUDA tensors every shape goes to the kernel, which raises on
    what it cannot take (the JAX package's TPU tiling gate does not carry
    over: B7 takes any ``N``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (qkv, q_gain, k_gain)):
        return _RopeQKNorm.apply(qkv, q_gain, k_gain, cos, sin, heads, eps)
    return rope_qk_norm_forward(qkv, q_gain, k_gain, cos, sin, heads, eps, in_place=True)
