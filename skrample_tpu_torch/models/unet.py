"""A compact SD-style conv UNet as a PyTorch module, and the parameter
machinery the conv families share.

The same network as the JAX package's ``models/unet.py``, parameter for
parameter.  The interior runs channels-last: activations are contiguous
``(B, H, W, C)`` tensors that kernel B12 (``ops/fused_conv.py``) reads as
they are, and every other convolution takes as their ``(B, C, H, W)`` view
(``torch.channels_last`` strides); every GroupNorm reads the ``(B, H*W,
C)`` view through kernel B8 (``ops/groupnorm.py``) without a copy.  One
transpose at entry and exit; the ``apply`` interface is NCHW.  Conv weights
keep the JAX tree's OIHW shape (checkpoint-portable) in ``channels_last``
memory: the (Co, 3, 3, C) layout B12 reads, and the one cuDNN takes
without a relayout.  ``UNetConfig.layout`` is accepted for parity with the
JAX configuration and ignored: NCHW against NHWC was a choice of TPU lane
layout.

Parameters live in one tree that mirrors the JAX package's
(``tree["down"][0]["blocks"][0]["conv1"]``), leaves being :class:`_Conv`,
``nn.Linear`` and :class:`_Affine` modules, so the forward reads as the JAX
one does; :meth:`_TreeModule.load_jax_params` and
:meth:`_TreeModule.param_tree` carry the numpy tree across both ways.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Iterator
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops._cuda import resolve_device
from ..ops.flash_attention import _packed_reference
from ..ops.fused_conv import conv3x3_gn_silu, cudnn_tf32
from ..ops.groupnorm import groupnorm_cl
from ..parallel import tensor_parallel
from .dit import _Dense, _dense, _dense_forward, _timestep_embedding

__all__ = ["UNet", "UNetConfig", "random_param_tree"]


@dataclass(frozen=True)
class UNetConfig:
    channels: int = 4
    base: int = 64
    "Channel width at full resolution; doubles per down level."
    levels: int = 3
    blocks_per_level: int = 1
    groups: int = 16
    compute_dtype: torch.dtype = torch.bfloat16
    layout: str = "auto"
    """Accepted for parity with the JAX configuration; the port's interior
    is always channels-last (the JAX package's choice was a TPU lane one)."""


# ---- parameter leaves and the tree ------------------------------------------------


@dataclass(frozen=True)
class _ConvSpec:
    k: int
    c_in: int
    c_out: int
    scale: float | None = None  # None: 1/sqrt(k*k*c_in); 0: zero weights


@dataclass(frozen=True)
class _DenseSpec:
    d_in: int
    d_out: int
    scale: float | None = None  # None: 1/sqrt(d_in)


@dataclass(frozen=True)
class _AffineSpec:
    width: int


@dataclass(frozen=True)
class _TConvSpec:
    "A causal temporal conv (the video VAE's): ``w`` (k, c_in, c_out), ``b`` (c_out,)."

    k: int
    c_in: int
    c_out: int
    scale: float | None = None  # None: 1/sqrt(k*c_in); 0: zero weights


class _Conv(nn.Module):
    "A conv's ``w`` (OIHW shape, channels_last memory) and ``b``."

    def __init__(self, spec: _ConvSpec, dtype: torch.dtype) -> None:
        super().__init__()
        shape = (spec.c_out, spec.c_in, spec.k, spec.k)
        w = torch.empty(shape, device="meta", dtype=dtype).to(memory_format=torch.channels_last)
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(torch.empty(spec.c_out, device="meta", dtype=dtype))


class _TConv(nn.Module):
    "A temporal conv's ``w`` (k, C, Co) and ``b``, the JAX tree's layout."

    def __init__(self, spec: _TConvSpec, dtype: torch.dtype) -> None:
        super().__init__()
        self.w = nn.Parameter(torch.empty((spec.k, spec.c_in, spec.c_out), device="meta", dtype=dtype))
        self.b = nn.Parameter(torch.empty(spec.c_out, device="meta", dtype=dtype))


class _Affine(nn.Module):
    "A norm's float32 gain ``g`` and bias ``b``."

    def __init__(self, spec: _AffineSpec) -> None:
        super().__init__()
        self.g = nn.Parameter(torch.empty(spec.width, device="meta", dtype=torch.float32))
        self.b = nn.Parameter(torch.empty(spec.width, device="meta", dtype=torch.float32))


_Leaf = _Conv | nn.Linear | _Affine | _TConv
_Spec = _ConvSpec | _DenseSpec | _AffineSpec | _TConvSpec


def _leaf(spec: _Spec, dtype: torch.dtype) -> _Leaf:
    if isinstance(spec, _ConvSpec):
        return _Conv(spec, dtype)
    if isinstance(spec, _TConvSpec):
        return _TConv(spec, dtype)
    if isinstance(spec, _DenseSpec):
        return nn.Linear(spec.d_in, spec.d_out, device="meta", dtype=dtype)
    return _Affine(spec)


def _walk(node: Any, path: str = "") -> Iterator[tuple[str, Any]]:
    "(dotted path, leaf) over nested dicts and lists, in order; None entries are skipped."
    if isinstance(node, dict):
        for key, value in node.items():
            yield from _walk(value, f"{path}{key}.")
    elif isinstance(node, list | tuple):
        for i, value in enumerate(node):
            yield from _walk(value, f"{path}{i}.")
    elif node is not None:
        yield path[:-1], node


def _map(node: Any, fn: Callable[[Any], Any]) -> Any:
    "The nested structure with ``fn`` applied to every leaf (None stays None)."
    if isinstance(node, dict):
        return {key: _map(value, fn) for key, value in node.items()}
    if isinstance(node, list | tuple):
        return [_map(value, fn) for value in node]
    return None if node is None else fn(node)


def _leaf_arrays(leaf: _Leaf) -> dict[str, np.ndarray]:
    "A leaf as the JAX tree holds it: float32 numpy, dense ``w`` as (d_in, d_out)."
    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    if isinstance(leaf, nn.Linear):
        return {"w": np.ascontiguousarray(host(leaf.weight).T), "b": host(leaf.bias)}
    if isinstance(leaf, _Conv | _TConv):
        return {"w": np.ascontiguousarray(host(leaf.w)), "b": host(leaf.b)}
    return {"g": host(leaf.g), "b": host(leaf.b)}


def _spec_arrays(spec: _Spec, normal: Callable[[tuple[int, ...]], Any], zeros: Callable, ones: Callable) -> dict:
    "The JAX package's initialisation of one leaf: normal weights scaled by 1/sqrt(fan-in), zero biases, unit gains."
    if isinstance(spec, _ConvSpec):
        shape = (spec.c_out, spec.c_in, spec.k, spec.k)
        scale = spec.scale if spec.scale is not None else 1 / math.sqrt(spec.k * spec.k * spec.c_in)
        return {"w": normal(shape) * scale if scale else zeros(shape), "b": zeros((spec.c_out,))}
    if isinstance(spec, _TConvSpec):
        shape = (spec.k, spec.c_in, spec.c_out)
        scale = spec.scale if spec.scale is not None else 1 / math.sqrt(spec.k * spec.c_in)
        return {"w": normal(shape) * scale if scale else zeros(shape), "b": zeros((spec.c_out,))}
    if isinstance(spec, _DenseSpec):
        shape = (spec.d_in, spec.d_out)
        scale = spec.scale if spec.scale is not None else 1 / math.sqrt(spec.d_in)
        return {"w": normal(shape) * scale if scale else zeros(shape), "b": zeros((spec.d_out,))}
    return {"g": ones((spec.width,)), "b": zeros((spec.width,))}


_NOISE = 0.02  # the JAX tests' perturbation of every leaf (tests/test_sdxl_stack.py)


def _random_tree(skeleton: Any, seed: int) -> dict:
    """A JAX-layout tree from a numpy seed: the standard initialisation plus
    ``0.02 * N(0, 1)`` on every leaf (the JAX tests' recipe for random
    weights that exercise every path: zero-initialised output layers would
    otherwise make the prediction exactly 0)."""
    rng = np.random.default_rng(seed)

    def normal(shape: tuple[int, ...]) -> np.ndarray:
        return rng.standard_normal(shape, dtype=np.float32)

    def zeros(shape: tuple[int, ...]) -> np.ndarray:
        return np.zeros(shape, np.float32)

    def ones(shape: tuple[int, ...]) -> np.ndarray:
        return np.ones(shape, np.float32)

    def leaf(spec: _Spec) -> dict:
        arrays = _spec_arrays(spec, normal, zeros, ones)
        return {k: (v + np.float32(_NOISE) * normal(v.shape)).astype(np.float32) for k, v in arrays.items()}

    return _map(skeleton, leaf)


class _TreeModule(nn.Module):
    """A module whose parameters form the JAX package's tree: ``self.tree``
    holds the leaf modules (and None where the JAX tree has None), and
    ``self.leaves`` registers them with PyTorch, numbered in tree order."""

    def _build(self, skeleton: Any, dtype: torch.dtype, device: torch.device) -> None:
        self._skeleton = skeleton
        self.leaves = nn.ModuleDict()

        def make(spec: _Spec) -> _Leaf:
            module = _leaf(spec, dtype)
            self.leaves[str(len(self.leaves))] = module
            return module

        self.tree = _map(skeleton, make)
        self.to_empty(device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None, noise: float = 0.0) -> None:
        """The JAX package's initialisation (see :func:`_spec_arrays`), then,
        with ``noise``, ``noise * N(0, 1)`` added to every leaf.  Drawn on
        ``generator``'s device (the CPU, seed 0, when omitted), one leaf at a
        time, then cast to the parameters' dtype."""
        gen = generator if generator is not None else torch.Generator().manual_seed(0)

        def normal(shape: tuple[int, ...]) -> torch.Tensor:
            return torch.randn(shape, generator=gen, device=gen.device)

        def zeros(shape: tuple[int, ...]) -> torch.Tensor:
            return torch.zeros(shape, device=gen.device)

        def ones(shape: tuple[int, ...]) -> torch.Tensor:
            return torch.ones(shape, device=gen.device)

        specs = dict(_walk(self._skeleton))
        for path, leaf in _walk(self.tree):
            arrays = _spec_arrays(specs[path], normal, zeros, ones)
            if noise:
                arrays = {key: value + noise * normal(value.shape) for key, value in arrays.items()}
            if isinstance(leaf, nn.Linear):  # a tensor-parallel layer takes its part
                tensor_parallel.load_dense(leaf, arrays["w"], arrays["b"])
                continue
            for key, value in arrays.items():
                _target(leaf, key).copy_(value)

    def param_tree(self) -> dict:
        """The parameters as the JAX package's tree of float32 numpy arrays
        (dense ``w`` ``(d_in, d_out)``, the transpose of ``nn.Linear``'s; conv
        ``w`` OIHW): the inverse of :meth:`load_jax_params`."""
        return _map(self.tree, _leaf_arrays)

    @torch.no_grad()
    def load_jax_params(self, tree: dict) -> _TreeModule:
        """Fill the module from the JAX package's parameter tree (as the JAX
        model's ``init`` lays it out, numpy or jax arrays).  Every key must be
        consumed and every shape must match."""
        flat = dict(_walk(tree))
        expected: dict[str, tuple[torch.Tensor, bool]] = {}
        for path, leaf in _walk(self.tree):
            names = ("g", "b") if isinstance(leaf, _Affine) else ("w", "b")
            for key in names:
                expected[f"{path}.{key}"] = (_target(leaf, key), isinstance(leaf, nn.Linear) and key == "w")
        if set(flat) != set(expected):
            missing, extra = sorted(set(expected) - set(flat)), sorted(set(flat) - set(expected))
            raise ValueError(f"{type(self).__name__} param tree: missing {missing[:8]}, unexpected {extra[:8]}")
        for path, (target, transpose) in expected.items():  # every shape checked before anything is written
            shape = tuple(target.shape[::-1]) if transpose else tuple(target.shape)
            if np.shape(flat[path]) != shape:
                raise ValueError(f"{path}: shape {np.shape(flat[path])} does not fit {shape}")
        for path, (target, transpose) in expected.items():
            value = np.array(flat[path], dtype=np.float32)  # a copy: jax hands out read-only buffers
            target.copy_(torch.from_numpy(np.ascontiguousarray(value.T if transpose else value)))
        return self


def _target(leaf: _Leaf, key: str) -> torch.Tensor:
    "The parameter a JAX key names: ``w``/``b`` of a dense layer or conv, ``g``/``b`` of a norm."
    if isinstance(leaf, nn.Linear):
        return leaf.weight if key == "w" else leaf.bias
    return getattr(leaf, key)


# ---- building blocks --------------------------------------------------------------


def _conv(p: _Conv, x: torch.Tensor, dtype: torch.dtype, stride: int = 1, pad: str | int = "SAME") -> torch.Tensor:
    """A conv on a channels-last ``(B, H, W, C)`` activation, returning one,
    as the JAX package's ``_conv`` computes it: the float32 sum of the
    product, plus the float32 bias, rounded once to ``dtype``.

    ``pad``: "SAME" (at stride 2 on an even input it pads (0, 1), the VAE
    downsampler's asymmetric padding) or an int for torch-style symmetric
    padding (the conditional UNet's stride-2 downsample uses 1, which
    samples a different grid than SAME).  The routes (ROADMAP C7):

    * 1x1: a product with a float32 result plus the bias, one rounding
      (the dense layers' ``_dense``);
    * 3x3 at stride 1 in a 16-bit dtype: kernel B12 with the norm and the
      statistics off, any channel count (``ops/fused_conv.py``);
    * every other 16-bit conv (the stride-2 downsamplers): the operands
      upcast to float32 and cuDNN in TF32, whose 11 significant bits hold a
      bf16 value exactly, so the products are exact and the sum float32;
    * float32: cuDNN with TF32 off.

    cuDNN picks its algorithm by the whole problem's shape (a 1280-channel
    3x3 conv at 32x32 sums in another order at batch 4 than at batch 2), so
    where it runs each batch item is convolved alone: a request's output does
    not depend on the requests packed beside it.  B12 splits each item the
    same way at any batch."""
    k = p.w.shape[-1]
    w = p.w.to(dtype)
    x = x.to(dtype)
    if k == 1 and stride == 1:
        w2 = w.reshape(w.shape[0], w.shape[1])
        if torch.is_grad_enabled() and (x.requires_grad or w2.requires_grad or p.b.requires_grad):
            return _Dense.apply(x, w2, p.b)  # the card's f32-result product has no autograd formula of its own
        return _dense_forward(x, w2, p.b)
    if dtype != torch.float32 and k == 3 and stride == 1 and pad in ("SAME", 1):
        return conv3x3_gn_silu(x.contiguous(), w.permute(2, 3, 1, 0), p.b, out_stats=False)[0]
    if pad == "SAME":
        padding = 0
        if stride == 1:
            padding = k // 2
        else:
            pads = []
            for size in (x.shape[2], x.shape[1]):  # F.pad's order: W, then H
                total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
                pads += [total // 2, total - total // 2]
            x = F.pad(x, (0, 0, *pads))
    else:
        padding = pad
    exact = dtype != torch.float32  # a 16-bit conv in float32 on exact TF32 products
    w32, b32 = w.float(), p.b.float()
    items = x.permute(0, 3, 1, 2).split(1)
    with cudnn_tf32(exact):
        outs = [F.conv2d(item.float(), w32, b32, stride, padding) for item in items]
    y = outs[0] if len(outs) == 1 else torch.cat(outs)
    return y.permute(0, 2, 3, 1).to(dtype)


def _groupnorm(x: torch.Tensor, groups: int, silu: bool = False) -> torch.Tensor:
    "Grouped norm without affine (eps 1e-6), f32 statistics, optionally with the following SiLU: B8 on the card."
    return groupnorm_cl(x, groups, fuse_silu=silu)


def _upsample_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    "Nearest-neighbour resize of a channels-last ``(B, H, W, C)`` activation to ``size``."
    return F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="nearest").permute(0, 2, 3, 1)


def _to_channels_last(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    "NCHW latents -> contiguous NHWC in the compute dtype, one copy."
    return x.permute(0, 2, 3, 1).to(dtype, memory_format=torch.contiguous_format)


def _to_nchw(h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    "Contiguous NHWC -> contiguous NCHW in ``dtype``, one copy (the fused step reads contiguous latents)."
    return h.permute(0, 3, 1, 2).to(dtype, memory_format=torch.contiguous_format)


# ---- the UNet ---------------------------------------------------------------------


def _unet_skeleton(c: UNetConfig) -> dict:
    "The JAX ``UNet.init`` tree with leaf specs in place of arrays."
    temb_dim = c.base * 4
    widths = [c.base * (2**level) for level in range(c.levels)]

    def resblock(c_in: int, c_out: int) -> dict:
        return {
            "conv1": _ConvSpec(3, c_in, c_out),
            "conv2": _ConvSpec(3, c_out, c_out, scale=0.0),
            "temb": _DenseSpec(temb_dim, c_out),
            "skip": _ConvSpec(1, c_in, c_out) if c_in != c_out else None,
        }

    tree: dict = {
        "in_conv": _ConvSpec(3, c.channels, widths[0]),
        "t_mlp1": _DenseSpec(256, temb_dim),
        "t_mlp2": _DenseSpec(temb_dim, temb_dim),
        "down": [],
        "mid1": None,
        "mid_attn": None,
        "mid2": None,
        "up": [],
        "out_conv": _ConvSpec(3, widths[0], c.channels, scale=0.0),
    }
    for level, width in enumerate(widths):
        prev = widths[max(level - 1, 0)]
        blocks = [resblock(prev if b == 0 else width, width) for b in range(c.blocks_per_level)]
        down = _ConvSpec(3, width, width) if level < c.levels - 1 else None
        tree["down"].append({"blocks": blocks, "downsample": down})
    mid = widths[-1]
    tree["mid1"] = resblock(mid, mid)
    tree["mid_attn"] = {"qkv": _DenseSpec(mid, 3 * mid), "proj": _DenseSpec(mid, mid, scale=0.0)}
    tree["mid2"] = resblock(mid, mid)
    for level in reversed(range(c.levels)):
        width = widths[level]
        above = widths[min(level + 1, c.levels - 1)]
        blocks = [resblock((above + width) if b == 0 else width, width) for b in range(c.blocks_per_level)]
        tree["up"].append({"blocks": blocks})
    return tree


class UNet(_TreeModule):
    """``UNet(config)(x, t)``: (B, C, H, W) latents and a (B,) or scalar
    timestep -> a prediction of the latents' shape and dtype.

    Built on ``device`` (CUDA unless the caller asks for the CPU) with
    parameters in ``dtype`` (the norms have no affine here) and the JAX
    package's initialisation drawn from ``generator``: zero ``conv2``,
    ``out_conv`` and mid ``proj``, so a fresh model outputs exactly 0."""

    def __init__(
        self,
        config: UNetConfig = UNetConfig(),
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.config = config
        self._build(_unet_skeleton(config), dtype, resolve_device(device))
        self.reset_parameters(generator)

    def _resblock(self, p: dict, x: torch.Tensor, temb: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        c = self.config
        temb_b = _dense(p["temb"], temb, dtype)
        h = _conv(p["conv1"], _groupnorm(x, c.groups, silu=True), dtype)
        h = h + temb_b[:, None, None, :]
        h = _conv(p["conv2"], _groupnorm(h, c.groups, silu=True), dtype)
        skip = _conv(p["skip"], x, dtype) if p["skip"] is not None else x
        return skip + h

    def _attention(self, p: dict, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        "One-head self-attention over the (B, H*W, C) tokens, plain (the JAX package's einsum)."
        B, H, W, C = x.shape
        tokens = _groupnorm(x, self.config.groups).view(B, H * W, C)
        q, k, v = _dense(p["qkv"], tokens, dtype).chunk(3, dim=-1)
        out = _dense(p["proj"], _packed_reference(q, k, v, 1), dtype)
        return x + out.view(B, H, W, C)

    def forward(self, x: torch.Tensor, t: torch.Tensor | float) -> torch.Tensor:
        c = self.config
        dtype = c.compute_dtype
        tree = self.tree
        t = torch.as_tensor(t, device=x.device)
        if t.ndim == 0:
            t = t.expand(x.shape[0])

        temb = _timestep_embedding(t, 256)
        temb = _dense(tree["t_mlp2"], F.silu(_dense(tree["t_mlp1"], temb.to(dtype), dtype)), dtype)
        temb = F.silu(temb)

        h = _conv(tree["in_conv"], _to_channels_last(x, dtype), dtype)
        skips = []
        for level in tree["down"]:
            for block in level["blocks"]:
                h = self._resblock(block, h, temb, dtype)
            skips.append(h)
            if level["downsample"] is not None:
                h = _conv(level["downsample"], h, dtype, stride=2)

        h = self._resblock(tree["mid1"], h, temb, dtype)
        h = self._attention(tree["mid_attn"], h, dtype)
        h = self._resblock(tree["mid2"], h, temb, dtype)

        for level in tree["up"]:
            skip = skips.pop()
            if h.shape[1:3] != skip.shape[1:3]:
                h = _upsample_nearest(h, tuple(skip.shape[1:3]))
            h = torch.cat([h, skip], dim=-1)  # skip joins the first block only
            for block in level["blocks"]:
                h = self._resblock(block, h, temb, dtype)

        h = _groupnorm(h, c.groups, silu=True)
        h = _conv(tree["out_conv"], h, dtype)
        return _to_nchw(h, x.dtype)

    apply = forward

    def as_sampleable(self) -> Callable[[torch.Tensor, Any, Any, Any], torch.Tensor]:
        "Adapter to the sampling closure signature (x, t, sigma, alpha) -> pred."

        def model_fn(x: torch.Tensor, t: Any, s: Any, a: Any) -> torch.Tensor:
            return self(x, t)

        return model_fn


def random_param_tree(config: UNetConfig, seed: int) -> dict:
    """A JAX-layout UNet tree from a numpy seed: the standard initialisation
    plus ``0.02 * N(0, 1)`` on every leaf."""
    return _random_tree(_unet_skeleton(config), seed)
