"""A compact diffusion transformer (DiT) as a PyTorch module.

The same network as the JAX package's ``models/dit.py``, parameter for
parameter: master weights in float32, cast to ``compute_dtype`` at every
matmul (or stored in it for serving: :func:`cast_dense_weights`) with the
bias added in float32 before the one rounding, float32 layer norms
through the fused adaLN op, and attention straight off the fused qkv
projection.  :meth:`DiT.load_jax_params` carries a JAX parameter tree
across, so both packages run the same weights, and :meth:`DiT.param_tree`
carries them back.  The forward is differentiable end to end: the fused
adaLN and the fused-qkv attention are autograd Functions whose backwards
are kernels too, and ``remat`` recomputes each block's activations in the
backward as the JAX package's does.

:meth:`DiT.quantize_params` gives the int8 serving model (``ops/quant.py``).
The sequence-parallel attentions (``"ring"``, ``"ulysses"``) run over the
``sp`` dim of a :class:`~torch.distributed.device_mesh.DeviceMesh`
(``parallel/``): each rank holds its token shard of the residual stream,
and on a ``dp`` x ``sp`` mesh its ``dp`` chunk of the batch.  On a mesh
with a ``tp`` axis each rank keeps its shard of the layers that
:meth:`DiT.param_spec` splits (``parallel/tensor_parallel.py``) and runs
``heads / tp`` heads; the mesh may also carry ``sp`` for the ring and
ulysses attentions, whose gradient crosses the ranks as the forward did.
:meth:`DiT.apply_pipelined` runs the blocks as GPipe stages over a ``pp``
mesh axis (``parallel/pipeline_stages.py``).
"""

from __future__ import annotations

import copy
import functools
import itertools
import math
from collections.abc import Callable
from dataclasses import dataclass
from typing import Any, TypeVar

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from ..ops._cuda import resolve_device
from ..ops.adaln import adaln_modulate
from ..ops.flash_attention import flash_attention, flash_attention_qkv
from ..ops.quant import MIN_QUANT_SIZE, Int8Dense, dense_int8
from ..parallel import gather, tensor_parallel
from ..parallel.pipeline_stages import model_stages, run_stages
from ..parallel.ring_attention import axis_group, ring_attention
from ..parallel.ulysses import ulysses_attention

_LATER = "comes with a later slice of the port (ROADMAP.md queue A)"


@dataclass(frozen=True)
class DiTConfig:
    patch: int = 2
    channels: int = 4
    dim: int = 384
    depth: int = 6
    heads: int = 6
    mlp_ratio: int = 4
    compute_dtype: torch.dtype = torch.bfloat16
    attention: str = "full"
    """``"full"`` (plain attention; the (N, N) scores hit device memory),
    ``"flash"`` (kernel K2 straight off the fused qkv projection at
    head_dim 128, K4 and K5 where a gradient is wanted; kernel B9 on the
    (B, H, N, d) views of the q/k/v thirds at a head dim that is not a
    multiple of 128, with the plain version's gradient), ``"ring"``
    (sequence-parallel exact attention: K/V blocks rotate over the mesh's
    ``sp_axis``, each hop through kernel B11) or ``"ulysses"``
    (sequence-parallel through head-sharding all-to-alls, B9 on each rank's
    head shard over the whole sequence).  Ring and ulysses need
    ``DiT(config, mesh=...)`` with the ``sp_axis``; they serve: a
    gradient through the collectives raises."""
    sp_axis: str = "sp"
    remat: bool | str = False
    """Recompute each transformer block's activations in the backward
    (per-block non-reentrant :func:`torch.utils.checkpoint.checkpoint`):
    ``True`` recomputes the whole block, ``"dots"`` keeps the dense layers'
    matmul outputs and recomputes the rest, as the JAX package's
    ``dots_with_no_batch_dims_saveable`` policy does; ``False`` stores
    every activation."""

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


def _dense_forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    "The forward of :class:`_Dense`, also taken alone where no gradient is wanted."
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda and x2.dtype != torch.float32:
        y = torch.addmm(b.float(), x2, w.t(), out_dtype=torch.float32)
    else:
        y = torch.addmm(b.float(), x2.float(), w.t().float())
    return y.to(x.dtype).view(*x.shape[:-1], y.shape[-1])


class _Dense(torch.autograd.Function):
    """``x @ wᵀ + b`` as the JAX package's ``_dense`` computes it: the product
    with a float32 result, plus the float32 bias, rounded once to the
    compute dtype; the bias gradient summed in float32.

    On the card a 16-bit product takes ``torch.addmm(b, x, wᵀ,
    out_dtype=float32)`` (``aten.addmm.dtype``: the float32 sum of the
    product and the bias); on the CPU, the same of the upcast operands.
    Nothing writes into that sum, which ``remat="dots"`` keeps; its one
    rounding to the compute dtype is a separate pass.  The backward:
    ``dx = g @ w`` and ``dw = gᵀ @ x`` in the compute dtype, ``db`` the
    float32 sum of ``g`` over rows."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x.reshape(-1, x.shape[-1]), w)
        ctx.bias_dtype = b.dtype
        return _dense_forward(x, w, b)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> tuple[torch.Tensor | None, ...]:
        x2, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = g2.mm(w).view(*g.shape[:-1], w.shape[1]) if ctx.needs_input_grad[0] else None
        dw = g2.t().mm(x2) if ctx.needs_input_grad[1] else None
        db = g2.float().sum(0).to(ctx.bias_dtype) if ctx.needs_input_grad[2] else None
        return dx, dw, db


_EPILOGUE_DTYPES = (torch.bfloat16, torch.float16)


def _dense(layer: nn.Linear | Int8Dense, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The JAX package's ``_dense``: ``x @ w + b`` with ``w`` cast to
    ``dtype``, the product and the bias add in float32, one rounding to
    ``dtype`` (:class:`_Dense`); an int8 layer of a serving model goes
    through :func:`~skrample_tpu_torch.ops.quant.dense_int8`.

    Where no gradient is wanted, on the card, a 16-bit product whose weight
    and bias are in ``x``'s dtype is one ``torch.addmm(b, x, wᵀ)``: cuBLASLt
    adds the bias to the float32 accumulator and rounds once, the same bits
    as the two passes of :func:`_dense_forward` without their float32 (R, N)
    round trip (``chip_smoke.py`` phase 16e holds the two to each other at
    every served shape).  A float32 bias keeps the two passes: rounding it
    first would change the sum.  A weight already in ``dtype`` is read as it
    is (:func:`cast_dense_weights`).

    A layer cut for tensor parallelism (``layer.tp``, ``parallel/tensor_parallel.py``)
    does its collective: a column-parallel one runs this on its columns, a
    row-parallel one reduces its float32 partial sums over ``tp`` before the
    bias."""
    if getattr(layer, "tp", None) is not None:
        return tensor_parallel.dense(layer, x, dtype, _dense_local)
    return _dense_local(layer, x, dtype)


def _dense_local(layer: nn.Linear | Int8Dense, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    "The body of :func:`_dense` on the layer's own weights."
    if isinstance(layer, Int8Dense):
        return dense_int8(layer.params(), x, dtype)
    w, b = layer.weight.to(dtype), layer.bias
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or b.requires_grad):
        return _Dense.apply(x, w, b)
    if x.is_cuda and x.dtype in _EPILOGUE_DTYPES and w.dtype == b.dtype == x.dtype:
        return torch.addmm(b, x.reshape(-1, x.shape[-1]), w.t()).view(*x.shape[:-1], w.shape[0])
    return _dense_forward(x, w, b)


_Module = TypeVar("_Module", bound=nn.Module)


@torch.no_grad()
def cast_dense_weights(model: _Module, dtype: torch.dtype) -> _Module:
    """Store every ``nn.Linear`` weight of ``model`` in ``dtype``, in place;
    biases and every other parameter keep their dtype.  A model with float32
    masters, served in ``dtype``, then reads its weights as they are instead
    of casting each one at every call, and holds half their memory; the
    masters are gone, so a gradient step after this updates the ``dtype``
    weights.  The served bits do not move: the weight is the cast that
    ``_dense`` made at each call, and float32 biases keep the two passes.
    ``load_jax_params`` and any other in-place update land in the weights
    that the forward reads, and so in a CUDA graph captured over it."""
    for layer in model.modules():
        if isinstance(layer, nn.Linear) and layer.weight.dtype != dtype:
            layer.weight = nn.Parameter(layer.weight.to(dtype), requires_grad=layer.weight.requires_grad)
    return model


# the dense layers' products: ``aten.addmm.dtype`` on the card, ``aten.addmm`` on the CPU
_DENSE_OPS = frozenset({torch.ops.aten.addmm.dtype, torch.ops.aten.addmm.default})


def _save_dense_outputs(ctx: Any, op: Any, *args: Any, **kwargs: Any) -> CheckpointPolicy:
    """The ``"dots"`` policy: keep the output of every matmul without batch
    dimensions (the dense layers' float32 products), recompute everything
    else, batched attention products included."""
    return CheckpointPolicy.MUST_SAVE if op in _DENSE_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def _int8_copy(model: nn.Module, exclude: frozenset[str]) -> nn.Module:
    """The int8 serving copy of ``model``: every ``nn.Linear`` that the JAX
    package's ``quantize_params`` (with ``exclude``) would quantize becomes an
    :class:`~skrample_tpu_torch.ops.quant.Int8Dense`; every other parameter is
    shared with ``model``, not copied.  A tensor-parallel layer is quantized
    from its own shard (``tensor_parallel.quantize_weight``), by the whole
    layer's size rule, and keeps its cut."""
    swaps: dict[str, Int8Dense] = {}
    for name, layer in model.named_modules():
        if not isinstance(layer, nn.Linear) or exclude.intersection(name.split(".")):
            continue
        d_in, d_out = tensor_parallel.whole_features(layer)
        if d_in * d_out < MIN_QUANT_SIZE:
            continue
        swaps[name] = Int8Dense({"w_q": tensor_parallel.quantize_weight(layer), "b": layer.bias.detach()})
        if getattr(layer, "tp", None) is not None:
            swaps[name].tp = layer.tp
    shared = {id(t): t for t in itertools.chain(model.parameters(), model.buffers())}
    # process groups are shared, never copied
    shared.update({id(m.tp): m.tp for m in model.modules() if getattr(m, "tp", None) is not None})
    mesh = getattr(model, "mesh", None)
    if mesh is not None:
        shared[id(mesh)] = mesh
    clone = copy.deepcopy(model, shared)
    for name, layer in swaps.items():
        parent, _, leaf = name.rpartition(".")
        setattr(clone.get_submodule(parent), leaf, layer)
    return clone


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts, _save_dense_outputs)


def _timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    "Sinusoidal features of the (continuous) timestep, ``[cos, sin]``."
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, head_dim: int) -> torch.Tensor:
    "Plain (B, H, N, d) attention with float32 scores, as the JAX DiT's ``'full'`` path."
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
    attn = torch.softmax(attn / math.sqrt(head_dim), dim=-1).to(q.dtype)
    return torch.matmul(attn.float(), v.float()).to(q.dtype)


class DiTBlock(nn.Module):
    "One transformer block: adaLN-zero attention + MLP residuals."

    def __init__(self, config: DiTConfig, mesh: Any = None) -> None:
        super().__init__()
        c = config
        self.config = c
        self.mesh = mesh
        self.qkv = nn.Linear(c.dim, 3 * c.dim, device="meta")
        self.proj = nn.Linear(c.dim, c.dim, device="meta")
        self.mlp_in = nn.Linear(c.dim, c.mlp_ratio * c.dim, device="meta")
        self.mlp_out = nn.Linear(c.mlp_ratio * c.dim, c.dim, device="meta")
        self.ada = nn.Linear(c.dim, 6 * c.dim, device="meta")

    def forward(self, tokens: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        c = self.config
        B, N, _ = tokens.shape
        dense = functools.partial(_dense, dtype=c.compute_dtype)
        mods = dense(self.ada, temb)
        # the JAX package's order: (shift, gate, scale) for attention, then MLP
        s_attn, g_attn, sc_attn, s_mlp, g_mlp, sc_mlp = mods.chunk(6, dim=-1)

        h = adaln_modulate(tokens, s_attn, sc_attn)
        qkv = dense(self.qkv, h)
        if c.attention == "flash" and c.head_dim % 128 == 0:
            out = flash_attention_qkv(qkv, c.heads)
        else:
            # (B, H, N, d) views of the q/k/v thirds: B9 reads them in place
            q, k, v = (
                part.reshape(B, N, c.heads, c.head_dim).transpose(1, 2) for part in qkv.chunk(3, dim=-1)
            )
            if c.attention == "ring":
                out = ring_attention(q, k, v, self.mesh, axis=c.sp_axis)
            elif c.attention == "ulysses":
                out = ulysses_attention(q, k, v, self.mesh, axis=c.sp_axis)
            elif c.attention == "flash":
                out = flash_attention(q, k, v)
            else:
                out = _full_attention(q, k, v, c.head_dim)
            out = out.transpose(1, 2).reshape(B, N, c.dim)
        tokens = tokens + g_attn[:, None] * dense(self.proj, out)

        h = adaln_modulate(tokens, s_mlp, sc_mlp)
        h = dense(self.mlp_out, F.gelu(dense(self.mlp_in, h), approximate="tanh"))
        return tokens + g_mlp[:, None] * h


class DiT(nn.Module):
    """``DiT(config)(x, t)``: (B, C, H, W) latents and a (B,) or scalar
    timestep -> a prediction of the latents' shape and dtype.

    With ``attention="ring"`` or ``"ulysses"``, ``mesh`` is a
    :class:`~torch.distributed.device_mesh.DeviceMesh` with the config's
    ``sp_axis``: every rank of the axis calls the forward on the same input
    and gets the same whole output, and in between holds only its contiguous
    range of the tokens.  On a mesh with a ``"dp"`` dim the input is this
    rank's ``dp`` chunk of the batch (``parallel.shard_batch``; the batch
    splits over ``dp`` first, as the JAX package's ``batch_axis_of`` puts it
    on the batch dim), and the tokens split over this rank's own ``sp``
    sub-group.

    Built on ``device`` (CUDA unless the caller asks for the CPU) with the
    JAX package's initialisation drawn from ``generator`` (a CPU generator;
    seed 0 when omitted): normal weights scaled by ``1/sqrt(d_in)``, zero
    biases, and zero ``ada``/``final_mod``/``final_out`` (adaLN-zero, so a
    fresh model outputs exactly 0)."""

    def __init__(
        self,
        config: DiTConfig = DiTConfig(),
        mesh: Any = None,
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        if config.attention not in ("full", "flash", "ring", "ulysses"):
            raise ValueError(f"unknown attention kind {config.attention!r}")
        if config.attention in ("ring", "ulysses"):
            if mesh is None:
                raise ValueError(
                    f"DiTConfig(attention={config.attention!r}) needs DiT(config, mesh=...) with the sp axis"
                )
            axis_group(mesh, config.sp_axis)  # raises on a mesh without the axis
        elif mesh is not None and "tp" not in (mesh.mesh_dim_names or ()):
            raise ValueError(
                f"DiT(mesh=...) with attention={config.attention!r} needs a 'tp' mesh axis (tensor parallelism; "
                "sequence parallelism is attention='ring' or 'ulysses'; data parallelism is the caller's: shard "
                "the batch, parallel.shard_batch)"
            )
        if config.remat not in (False, True, "dots"):
            raise ValueError(f"remat must be bool or 'dots', got {config.remat!r}")
        self.config = c = config
        self.mesh = mesh
        device = resolve_device(device)
        patch_dim = c.channels * c.patch * c.patch
        self.patch_in = nn.Linear(patch_dim, c.dim, device="meta")
        self.t_mlp1 = nn.Linear(256, c.dim, device="meta")
        self.t_mlp2 = nn.Linear(c.dim, c.dim, device="meta")
        self.final_mod = nn.Linear(c.dim, 2 * c.dim, device="meta")
        self.final_out = nn.Linear(c.dim, patch_dim, device="meta")
        self.blocks = nn.ModuleList(DiTBlock(c, mesh) for _ in range(c.depth))
        if tensor_parallel.tp_size(mesh) > 1:  # each rank holds its shard and runs heads / tp heads
            local = tensor_parallel.local_config(c, mesh)
            tensor_parallel.cut_on_meta(tensor_parallel.linears(self), self.param_spec(), mesh, self._tp_segments())
            for block in self.blocks:
                block.config = local
        self.to_empty(device=device)
        self.reset_parameters(generator)

    def _tp_segments(self) -> dict[str, tuple[int, ...]]:
        "The fused qkv's three parts, each split over ``tp`` by heads."
        d = self.config.dim
        return {f"blocks.{i}.qkv": (d, d, d) for i in range(self.config.depth)}

    def _layers(self) -> list[tuple[str, nn.Linear]]:
        "(name, layer) in the JAX tree's order, block layers as ``blocks.i.name``."
        named = [(name, getattr(self, name)) for name in ("patch_in", "t_mlp1", "t_mlp2", "final_mod", "final_out")]
        for i, block in enumerate(self.blocks):
            named += [(f"blocks.{i}.{name}", getattr(block, name)) for name in _BLOCK_LAYERS]
        return named

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        "The JAX package's initialisation (see the class docstring)."
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for name, layer in self._layers():
            zero = name.split(".")[-1] in _ZERO_INIT
            d_in, d_out = tensor_parallel.whole_features(layer)
            w = torch.randn(d_in, d_out, generator=generator) / math.sqrt(d_in)
            tensor_parallel.load_dense(layer, torch.zeros_like(w) if zero else w, torch.zeros(d_out))

    def param_tree(self) -> dict:
        """The module's parameters as the JAX package's tree of float32 numpy
        arrays (``w`` ``(d_in, d_out)``, the transpose of ``nn.Linear``'s):
        the inverse of :meth:`load_jax_params`, for saving in the JAX
        package's format and for comparing with it."""
        tree: dict = {"blocks": [{} for _ in self.blocks]}
        for name, layer in self._layers():
            node = tree
            *path, leaf = name.split(".")
            for part in path:
                node = node[int(part)] if part.isdigit() else node[part]
            node[leaf] = {
                "w": np.ascontiguousarray(layer.weight.detach().float().cpu().numpy().T),
                "b": layer.bias.detach().float().cpu().numpy().copy(),
            }
        return tree

    @torch.no_grad()
    def load_jax_params(self, tree: dict) -> DiT:
        """Fill the module from the JAX package's parameter tree.

        ``tree`` is laid out as ``skrample_tpu.models.dit.DiT.init`` returns
        it, as numpy (or any array convertible with ``np.asarray``):
        ``{"patch_in": {"w": (d_in, d_out), "b": (d_out,)}, ..., "blocks":
        [{"qkv": ..., "proj": ..., "mlp_in": ..., "mlp_out": ..., "ada": ...}]}``.
        A JAX ``w`` is ``(d_in, d_out)``; ``nn.Linear`` holds its transpose.
        Every key must be consumed and every shape must match."""
        expected = {"patch_in", "t_mlp1", "t_mlp2", "final_mod", "final_out", "blocks"}
        if set(tree) != expected:
            raise ValueError(f"DiT param tree keys {sorted(tree)} != {sorted(expected)}")
        tree = tensor_parallel.shard_params(tree, self.param_spec(), self.mesh, self._tp_segments())
        if len(tree["blocks"]) != len(self.blocks):
            raise ValueError(f"param tree has {len(tree['blocks'])} blocks, model depth is {len(self.blocks)}")
        for name, layer in self._layers():
            entry: Any = tree
            for part in name.split("."):
                entry = entry[int(part)] if part.isdigit() else entry[part]
            if "w_q" in entry:
                raise NotImplementedError("an int8 tree does not load: load the float tree, then quantize_params()")
            if set(entry) != {"w", "b"}:
                raise ValueError(f"{name}: expected keys w, b; got {sorted(entry)}")
            w = np.array(entry["w"], dtype=np.float32)  # a copy: jax hands out read-only buffers
            b = np.array(entry["b"], dtype=np.float32)
            if w.shape != (layer.in_features, layer.out_features) or b.shape != (layer.out_features,):
                fits = f"{layer.in_features}->{layer.out_features}"
                raise ValueError(f"{name}: w {w.shape} / b {b.shape} do not fit a {fits} layer")
            layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.T)))
            layer.bias.copy_(torch.from_numpy(b))
        return self

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        "(B, C, H, W) -> (B, N, patch_dim)"
        c = self.config
        B, C, H, W = x.shape
        x = x.reshape(B, C, H // c.patch, c.patch, W // c.patch, c.patch)
        x = x.permute(0, 2, 4, 1, 3, 5)
        return x.reshape(B, (H // c.patch) * (W // c.patch), C * c.patch * c.patch)

    def unpatchify(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        c = self.config
        B = x.shape[0]
        x = x.reshape(B, H // c.patch, W // c.patch, c.channels, c.patch, c.patch)
        x = x.permute(0, 3, 1, 4, 2, 5)
        return x.reshape(B, c.channels, H, W)

    def forward(self, x: torch.Tensor, t: torch.Tensor | float) -> torch.Tensor:
        "(B, C, H, W), (B,) or scalar timestep -> prediction of the same shape and dtype."
        c = self.config
        dtype = c.compute_dtype
        B, _C, H, W = x.shape
        t = torch.as_tensor(t, device=x.device)
        if t.ndim == 0:
            t = t.expand(B)

        patches = self.patchify(x)
        sequence_parallel = c.attention in ("ring", "ulysses")
        if sequence_parallel:
            # this rank's contiguous token range: the JAX package's P(batch, "sp", None) layout
            _group, size, rank = axis_group(self.mesh, c.sp_axis)
            if patches.shape[1] % size:
                raise ValueError(f"tokens ({patches.shape[1]}) must divide the {c.sp_axis!r} axis size ({size})")
            patches = patches.chunk(size, dim=1)[rank]
        tokens = _dense(self.patch_in, patches.to(dtype), dtype)
        temb = self._time_embedding(t)

        for block in self.blocks:
            if c.remat and torch.is_grad_enabled():
                context = _DOTS_CONTEXT if c.remat == "dots" else noop_context_fn
                tokens = checkpoint(block, tokens, temb, use_reentrant=False, context_fn=context)
            else:
                tokens = block(tokens, temb)

        shift, scale = _dense(self.final_mod, temb, dtype).chunk(2, dim=-1)
        tokens = adaln_modulate(tokens, shift, scale)
        out = _dense(self.final_out, tokens, dtype)
        if sequence_parallel:
            out = gather(self.mesh, out, dim=1, axis=c.sp_axis)
        return self.unpatchify(out, H, W).to(x.dtype)

    apply = forward

    def _time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        "(B,) timesteps -> silu(t_mlp2(silu(t_mlp1(sinusoidal features))))."
        dtype = self.config.compute_dtype
        temb = _timestep_embedding(t, 256)
        temb = _dense(self.t_mlp2, F.silu(_dense(self.t_mlp1, temb.to(dtype), dtype)), dtype)
        return F.silu(temb)

    def apply_pipelined(
        self,
        x: torch.Tensor,
        t: torch.Tensor | float,
        mesh: Any,
        microbatch: int,
        axis: str = "pp",
        batch_axis: str | None = None,
    ) -> torch.Tensor:
        """Pipeline-parallel forward, the JAX package's ``apply_pipelined``: the blocks split into
        ``S = mesh.size(axis)`` consecutive stages, this rank running its own, and the ``(tokens,
        temb)`` carry streamed through them in microbatches of ``microbatch`` items (GPipe,
        ``parallel/pipeline_stages.py``): every block reads the conditioning vector, so it rides
        along.  The patch, time and final layers run on every stage rank, and every stage rank
        returns the output.  With ``batch_axis`` (pp x dp), ``x`` and ``t`` are this rank's chunk of
        the batch and ``microbatch`` counts items of the whole one.  Equals :meth:`forward` up to the
        order of the sums; differentiable (a stage's blocks get their gradient on its rank)."""
        c = self.config
        dtype = c.compute_dtype
        B, _C, H, W = x.shape
        blocks, mb, group = model_stages(self.blocks, mesh, axis, batch_axis, B, microbatch)
        t = torch.as_tensor(t, device=x.device)
        if t.ndim == 0:
            t = t.expand(B)
        tokens = _dense(self.patch_in, self.patchify(x).to(dtype), dtype)
        temb = self._time_embedding(t)

        def stage(_params: list[torch.Tensor], carry: tuple[torch.Tensor, torch.Tensor]) -> tuple:
            toks, te = carry
            for block in blocks:
                toks = block(toks, te)
            return toks, te

        count = B // mb
        params = [p for block in blocks for p in block.parameters()]
        carry = (tokens.reshape(count, mb, *tokens.shape[1:]), temb.reshape(count, mb, -1))
        toks, _ = run_stages(stage, params, carry, group)
        tokens = toks.reshape(B, *toks.shape[2:])
        shift, scale = _dense(self.final_mod, temb, dtype).chunk(2, dim=-1)
        out = _dense(self.final_out, adaln_modulate(tokens, shift, scale), dtype)
        return self.unpatchify(out, H, W).to(x.dtype)

    def quantize_params(self) -> DiT:
        """The int8 serving model: the block qkv/proj/mlp weights as
        per-channel int8 with dynamic per-row activation scales (kernel B6),
        as the JAX package's ``DiT.quantize_params`` builds its tree.  The
        conditioning pathway (``ada``, ``final_mod``, ``t_mlp1``,
        ``t_mlp2``) and layers under 16384 weights stay as they are and are
        shared with this model.  Serving only: rounding has no gradient."""
        return _int8_copy(self, frozenset({"ada", "final_mod", "t_mlp1", "t_mlp2"}))

    def param_spec(self, quantized: bool = False) -> dict:
        """The JAX package's tensor-parallel specs over ``tp`` (megatron layout): qkv and mlp_in
        column-parallel, proj and mlp_out row-parallel, the rest replicated; with ``quantized`` the
        int8 tree's (the codes split as the float weight, the per-channel scales with the output
        dim).  ``tensor_parallel.P`` tuples."""
        col, row, rep = tensor_parallel.dense_specs(quantized)
        return {
            "patch_in": rep,
            "t_mlp1": rep,
            "t_mlp2": rep,
            "final_mod": rep,
            "final_out": rep,
            "blocks": [
                {"qkv": col, "proj": row, "mlp_in": col, "mlp_out": row, "ada": rep}
                for _ in range(self.config.depth)
            ],
        }

    def as_sampleable(self) -> Callable[[torch.Tensor, Any, Any, Any], torch.Tensor]:
        "Adapter to the sampling closure signature (x, t, sigma, alpha) -> pred."

        def model_fn(x: torch.Tensor, t: Any, s: Any, a: Any) -> torch.Tensor:
            return self(x, t)

        return model_fn


_BLOCK_LAYERS = ("qkv", "proj", "mlp_in", "mlp_out", "ada")
_ZERO_INIT = frozenset({"ada", "final_mod", "final_out"})


def random_param_tree(config: DiTConfig, seed: int) -> dict:
    """A JAX-layout parameter tree with EVERY weight and bias drawn at random
    from a numpy seed (normal weights scaled by ``1/sqrt(d_in)``, normal
    biases scaled by 0.1).  The adaLN-zero initialisation makes a fresh model
    output exactly 0, so parity checks between the packages and between a
    kernel and its plain version draw all weights from this instead."""
    rng = np.random.default_rng(seed)
    c = config
    patch_dim = c.channels * c.patch * c.patch

    def dense(d_in: int, d_out: int) -> dict:
        w = rng.standard_normal((d_in, d_out), dtype=np.float32) / np.float32(math.sqrt(d_in))
        return {"w": w, "b": rng.standard_normal(d_out, dtype=np.float32) * np.float32(0.1)}

    tree: dict = {
        "patch_in": dense(patch_dim, c.dim),
        "t_mlp1": dense(256, c.dim),
        "t_mlp2": dense(c.dim, c.dim),
        "final_mod": dense(c.dim, 2 * c.dim),
        "final_out": dense(c.dim, patch_dim),
        "blocks": [],
    }
    for _ in range(c.depth):
        tree["blocks"].append(
            {
                "qkv": dense(c.dim, 3 * c.dim),
                "proj": dense(c.dim, c.dim),
                "mlp_in": dense(c.dim, c.mlp_ratio * c.dim),
                "mlp_out": dense(c.mlp_ratio * c.dim, c.dim),
                "ada": dense(c.dim, 6 * c.dim),
            }
        )
    return tree
