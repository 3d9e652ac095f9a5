"""The factorized spatio-temporal diffusion transformer for video latents
as a PyTorch module.

The same network as the JAX package's ``models/video_dit.py``, parameter
for parameter: ``(B, C, F, H, W)`` latents patchified frame by frame, a
factorized sinusoidal position (frame index + patch index), and blocks of
spatial attention (a frame's tokens attend to each other: frames fold into
the batch), temporal attention (each site attends across frames), an
optional text cross-attention and an MLP, each an adaLN-zero gated
residual.  Master weights in float32, cast to ``compute_dtype`` at every
product with the bias added in float32 (``_dense``); every LayerNorm is
the fused adaLN (kernel K3).

* Spatial attention is kernel K2 straight off the fused qkv projection
  (``flash_attention_qkv`` on the ``(B*F, N, 3*dim)`` view: a reshape, no
  copy), head dim 128.
* Temporal attention and the text cross-attention stay plain PyTorch, as
  the JAX package runs both as einsum outside any kernel: their score
  tensors are ``(F, F)`` and ``(F*N, T_txt)``, tiny next to the spatial
  ones.

:meth:`VideoDiT.as_sampleable` / :meth:`VideoDiT.as_served` run
classifier-free guidance as two SEQUENTIAL forwards against the learned
null context row, the JAX package's default for this family
(``cfg_batched=True`` doubles the batch instead).
:meth:`VideoDiT.quantize_params` gives the int8 serving model.

``sequence_parallel=True`` with ``mesh=`` is the JAX package's Ulysses-style
alternation over the mesh's ``sp`` axis: each rank holds a contiguous range
of the frames (every site of them) for the spatial attention, the MLP and
the cross-attention; one ``all_to_all_single`` re-buckets the temporal
branch's qkv so that each rank holds every frame of a range of the sites,
and one brings its output back.  The last layer's output is all-gathered
over the frames.  On a ``dp`` x ``sp`` mesh the input is the rank's ``dp``
chunk of the batch.  The gradient crosses the all-to-alls and the gather
back as the forward did.  Without ``sequence_parallel``, a mesh with a ``tp`` axis cuts the
layers :meth:`VideoDiT.param_spec` splits (``parallel/tensor_parallel.py``),
``heads / tp`` heads a rank.
"""

from __future__ import annotations

import functools
import math
from collections.abc import Callable
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, noop_context_fn

from ..ops._cuda import resolve_device
from ..ops.adaln import adaln_modulate
from ..ops.flash_attention import _qkv_reference, attention_reference, flash_attention_qkv
from ..parallel import gather, tensor_parallel
from ..parallel.ring_attention import axis_group
from ..parallel.ulysses import reshard
from .conditioning import guided_mix, per_item
from .dit import _DOTS_CONTEXT, _dense, _int8_copy, _timestep_embedding

__all__ = ["VideoDiT", "VideoDiTConfig", "random_param_tree", "video_dit_forward_flops"]


@dataclass(frozen=True)
class VideoDiTConfig:
    patch: int = 2
    channels: int = 16
    "Wan/LTX-class video latents carry 16 channels."
    dim: int = 512
    depth: int = 8
    heads: int = 4
    mlp_ratio: int = 4
    compute_dtype: torch.dtype = torch.bfloat16
    attention: str = "flash"
    '``"flash"`` (kernel K2, K4/K5 where a gradient is wanted) or ``"full"`` (plain attention).'
    context_dim: int = 0
    """Text-conditioning width.  ``0`` keeps the unconditioned model; ``> 0``
    adds a gated cross-attention branch per block and a learned null-context
    row for classifier-free guidance."""
    sequence_parallel: bool = False
    """Ulysses-style sp alternation: frames split over the mesh's ``sp_axis`` for the spatial
    attention, sites for the temporal one (requires ``mesh``; F and N must divide the axis size)."""
    sp_axis: str = "sp"
    remat: bool | str = False
    "Recompute each block's activations in the backward (see ``DiTConfig.remat``)."

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


_ZERO_INIT = frozenset({"ada", "final_mod", "final_out", "proj_x"})
_BLOCK_LAYERS = ("qkv_s", "proj_s", "qkv_t", "proj_t", "mlp_in", "mlp_out", "ada")
_CROSS_LAYERS = ("q_x", "kv_c", "proj_x")


class VideoDiTBlock(nn.Module):
    "Spatial + temporal (+ text cross) attention + MLP, each adaLN-zero gated."

    def __init__(self, config: VideoDiTConfig, mesh: Any = None) -> None:
        super().__init__()
        c = self.config = config
        self.mesh = mesh
        branches = 4 if c.context_dim else 3
        shapes = {
            "qkv_s": (c.dim, 3 * c.dim),
            "proj_s": (c.dim, c.dim),
            "qkv_t": (c.dim, 3 * c.dim),
            "proj_t": (c.dim, c.dim),
            "mlp_in": (c.dim, c.mlp_ratio * c.dim),
            "mlp_out": (c.mlp_ratio * c.dim, c.dim),
            "ada": (c.dim, 3 * branches * c.dim),
        }
        if c.context_dim:
            shapes.update(q_x=(c.dim, c.dim), kv_c=(c.context_dim, 2 * c.dim), proj_x=(c.dim, c.dim))
        for name, (d_in, d_out) in shapes.items():
            setattr(self, name, nn.Linear(d_in, d_out, device="meta"))

    def _attend(self, qkv: torch.Tensor) -> torch.Tensor:
        "Fused-qkv attention on a (rows, tokens, 3*dim) view."
        c = self.config
        if c.attention == "flash":
            return flash_attention_qkv(qkv, c.heads)
        return _qkv_reference(qkv, c.heads)

    def _temporal_attend(self, qkv: torch.Tensor) -> torch.Tensor:
        """Frame-axis attention on the frame-major ``(B, F, N, 3*dim)`` view:
        each (item, site, head) attends over the F frames, plain (float32
        scores and softmax, probabilities rounded to the compute dtype).  One
        item at a time: cuBLAS picks its batched product by the batch count,
        and an item's bits would then depend on the requests packed beside it."""
        c = self.config
        B, Fr, N, _ = qkv.shape
        parts = qkv.view(B, Fr, N, 3, c.heads, c.head_dim).unbind(3)
        q, k, v = (part.permute(0, 2, 3, 1, 4) for part in parts)  # (B, N, H, F, d)
        out = torch.cat([attention_reference(q[i : i + 1], k[i : i + 1], v[i : i + 1]) for i in range(B)])
        return out.permute(0, 3, 1, 2, 4).reshape(B, Fr, N, c.dim)

    def _cross_attend(self, q_tokens: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        "Every spatio-temporal token attends to the text tokens, plain: the scores are (F*N, T_txt)."
        c = self.config
        B, S, _ = q_tokens.shape
        dtype = q_tokens.dtype
        q = _dense(self.q_x, q_tokens, dtype).view(B, S, c.heads, c.head_dim).transpose(1, 2)
        kv = _dense(self.kv_c, context, dtype).view(B, -1, 2, c.heads, c.head_dim)
        k, v = (t.transpose(1, 2) for t in kv.unbind(2))
        out = torch.cat([attention_reference(q[i : i + 1], k[i : i + 1], v[i : i + 1]) for i in range(B)])  # as above
        return out.transpose(1, 2).reshape(B, S, c.dim)

    def forward(
        self, tokens: torch.Tensor, temb: torch.Tensor, context: torch.Tensor | None, frames: int, n: int
    ) -> torch.Tensor:
        c = self.config
        dense = functools.partial(_dense, dtype=c.compute_dtype)
        B = tokens.shape[0]
        mods = dense(self.ada, temb)
        if context is not None:
            s_sp, g_sp, c_sp, s_t, g_t, c_t, s_x, g_x, c_x, s_m, g_m, c_m = mods.chunk(12, dim=-1)
        else:
            s_sp, g_sp, c_sp, s_t, g_t, c_t, s_m, g_m, c_m = mods.chunk(9, dim=-1)

        # spatial: frames fold into the batch (frame-major tokens: a reshape)
        qkv = dense(self.qkv_s, adaln_modulate(tokens, s_sp, c_sp))
        out = self._attend(qkv.view(B * frames, n, 3 * c.dim)).reshape(B, frames * n, c.dim)
        tokens = tokens + g_sp[:, None] * dense(self.proj_s, out)

        # temporal: each site attends across frames, in place on the frame-major layout
        qkv = dense(self.qkv_t, adaln_modulate(tokens, s_t, c_t)).view(B, frames, n, 3 * c.dim)
        if not c.sequence_parallel:
            out = self._temporal_attend(qkv)
        else:  # frames -> sites for the temporal attention, and back
            group, size, _rank = axis_group(self.mesh, c.sp_axis)
            out = reshard(self._temporal_attend(reshard(qkv, group, size, 2, 1)), group, size, 1, 2)
        out = out.reshape(B, frames * n, c.dim)
        tokens = tokens + g_t[:, None] * dense(self.proj_t, out)

        if context is not None:
            out = self._cross_attend(adaln_modulate(tokens, s_x, c_x), context)
            tokens = tokens + g_x[:, None] * dense(self.proj_x, out)

        h = adaln_modulate(tokens, s_m, c_m)
        h = dense(self.mlp_out, F.gelu(dense(self.mlp_in, h), approximate="tanh"))
        return tokens + g_m[:, None] * h


class VideoDiT(nn.Module):
    """``VideoDiT(config)(x, t[, context])``: (B, C, F, H, W) latents and a
    (B,) or scalar timestep -> a prediction of the latents' shape and dtype.

    Built on ``device`` (CUDA unless the caller asks for the CPU) with the
    JAX package's initialisation drawn from ``generator`` (see
    :meth:`reset_parameters`)."""

    def __init__(
        self,
        config: VideoDiTConfig = VideoDiTConfig(),
        mesh: Any = None,
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        if config.sequence_parallel:
            if mesh is None:
                raise ValueError("sequence_parallel=True needs VideoDiT(config, mesh=...) with the sp axis")
            axis_group(mesh, config.sp_axis)  # raises on a mesh without the axis
        elif mesh is not None and "tp" not in (mesh.mesh_dim_names or ()):
            raise ValueError(
                "VideoDiT(mesh=...) without sequence_parallel needs a 'tp' mesh axis (tensor parallelism)"
            )
        if config.attention not in ("full", "flash"):
            raise ValueError(f"unknown attention kind {config.attention!r}")
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
        self.null_ctx = nn.Parameter(torch.empty(1, c.context_dim, device="meta")) if c.context_dim else None
        self.blocks = nn.ModuleList(VideoDiTBlock(c, self.mesh) for _ in range(c.depth))
        if tensor_parallel.tp_size(mesh) > 1:  # each rank holds its shard and runs heads / tp heads
            tensor_parallel.cut_on_meta(tensor_parallel.linears(self), self.param_spec(), mesh, self._tp_segments())
            for block in self.blocks:
                block.config = tensor_parallel.local_config(c, mesh)
        self.to_empty(device=device)
        self.reset_parameters(generator)

    def _tp_segments(self) -> dict[str, tuple[int, ...]]:
        "The fused qkv's three parts and the cross-attention's ``[k | v]``, each split over ``tp`` by heads."
        d = self.config.dim
        segments = {}
        for i in range(self.config.depth):
            segments.update({f"blocks.{i}.qkv_s": (d, d, d), f"blocks.{i}.qkv_t": (d, d, d), f"blocks.{i}.kv_c": (d, d)})
        return segments

    def _layers(self) -> list[tuple[str, nn.Linear]]:
        "(name, layer) in the JAX tree's order, block layers as ``blocks.i.name``."
        named = [(name, getattr(self, name)) for name in ("patch_in", "t_mlp1", "t_mlp2", "final_mod", "final_out")]
        names = _BLOCK_LAYERS + (_CROSS_LAYERS if self.config.context_dim else ())
        for i, block in enumerate(self.blocks):
            named += [(f"blocks.{i}.{name}", getattr(block, name)) for name in names]
        return named

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None, noise: float = 0.0) -> None:
        """The JAX package's initialisation: normal weights scaled by
        ``1/sqrt(d_in)``, zero biases, zero ``ada``/``final_mod``/``final_out``/
        ``proj_x`` (adaLN-zero: a fresh model outputs exactly 0), a
        ``0.02 * N(0, 1)`` null-context row; then, with ``noise``, ``noise *
        N(0, 1)`` added to every leaf (``scripts/bench_video.py``'s recipe
        for random weights that exercise every path).  Drawn on
        ``generator``'s device (the CPU, seed 0, when omitted)."""
        gen = generator if generator is not None else torch.Generator().manual_seed(0)

        def normal(*shape: int) -> torch.Tensor:
            return torch.randn(shape, generator=gen, device=gen.device)

        for name, layer in self._layers():
            d_in, d_out = tensor_parallel.whole_features(layer)
            zero = name.rpartition(".")[2] in _ZERO_INIT
            w = torch.zeros(d_in, d_out, device=gen.device) if zero else normal(d_in, d_out) / math.sqrt(d_in)
            b = torch.zeros(d_out, device=gen.device)
            if noise:
                w += noise * normal(d_in, d_out)
                b += noise * normal(d_out)
            tensor_parallel.load_dense(layer, w, b)
        if self.null_ctx is not None:
            row = normal(*self.null_ctx.shape) * 0.02
            self.null_ctx.copy_(row + noise * normal(*row.shape) if noise else row)

    def param_tree(self) -> dict:
        """The parameters as the JAX package's tree of float32 numpy arrays
        (``w`` ``(d_in, d_out)``, the transpose of ``nn.Linear``'s): the
        inverse of :meth:`load_jax_params`."""
        tree: dict = {"blocks": [{} for _ in self.blocks]}
        for name, layer in self._layers():
            *path, leaf = name.split(".")
            node = tree["blocks"][int(path[1])] if path else tree
            node[leaf] = {
                "w": np.ascontiguousarray(layer.weight.detach().float().cpu().numpy().T),
                "b": layer.bias.detach().float().cpu().numpy().copy(),
            }
        if self.null_ctx is not None:
            tree["null_ctx"] = self.null_ctx.detach().float().cpu().numpy().copy()
        return tree

    @torch.no_grad()
    def load_jax_params(self, tree: dict) -> VideoDiT:
        """Fill the module from the JAX package's parameter tree (as
        ``VideoDiT.init`` lays it out, numpy or jax arrays).  Every key must be
        consumed and every shape must match."""
        expected = {"patch_in", "t_mlp1", "t_mlp2", "final_mod", "final_out", "blocks"}
        if self.null_ctx is not None:
            expected.add("null_ctx")
        if set(tree) != expected:
            raise ValueError(f"VideoDiT param tree keys {sorted(tree)} != {sorted(expected)}")
        tree = tensor_parallel.shard_params(tree, self.param_spec(), self.mesh, self._tp_segments())
        if len(tree["blocks"]) != len(self.blocks):
            raise ValueError(f"param tree has {len(tree['blocks'])} blocks, model depth is {len(self.blocks)}")
        names = set(_BLOCK_LAYERS + (_CROSS_LAYERS if self.config.context_dim else ()))
        for i, block in enumerate(tree["blocks"]):
            if set(block) != names:
                raise ValueError(f"block {i}: keys {sorted(block)} != {sorted(names)}")
        for name, layer in self._layers():
            *path, leaf = name.split(".")
            entry = (tree["blocks"][int(path[1])] if path else tree)[leaf]
            if "w_q" in entry:
                raise NotImplementedError("an int8 tree does not load: load the float tree, then quantize_params()")
            w = np.array(entry["w"], dtype=np.float32)  # a copy: jax hands out read-only buffers
            b = np.array(entry["b"], dtype=np.float32)
            if w.shape != (layer.in_features, layer.out_features) or b.shape != (layer.out_features,):
                fits = f"{layer.in_features}->{layer.out_features}"
                raise ValueError(f"{name}: w {w.shape} / b {b.shape} do not fit a {fits} layer")
            layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.T)))
            layer.bias.copy_(torch.from_numpy(b))
        if self.null_ctx is not None:
            row = np.array(tree["null_ctx"], dtype=np.float32)
            if row.shape != tuple(self.null_ctx.shape):
                raise ValueError(f"null_ctx: shape {row.shape} != {tuple(self.null_ctx.shape)}")
            self.null_ctx.copy_(torch.from_numpy(row))
        return self

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        "(B, C, F, H, W) -> (B, F, N, patch_dim): frames keep their own token rows."
        c = self.config
        B, C, Fr, H, W = x.shape
        x = x.reshape(B, C, Fr, H // c.patch, c.patch, W // c.patch, c.patch)
        x = x.permute(0, 2, 3, 5, 1, 4, 6)
        return x.reshape(B, Fr, (H // c.patch) * (W // c.patch), C * c.patch * c.patch)

    def unpatchify(self, x: torch.Tensor, frames: int, H: int, W: int) -> torch.Tensor:
        c = self.config
        B = x.shape[0]
        x = x.reshape(B, frames, H // c.patch, W // c.patch, c.channels, c.patch, c.patch)
        x = x.permute(0, 4, 1, 2, 5, 3, 6)
        return x.reshape(B, c.channels, frames, H, W)

    def _posemb(self, frames: int, n: int, device: torch.device) -> torch.Tensor:
        "Factorized sinusoidal position features (F, N, dim), float32: frame index + patch index."
        dim = self.config.dim
        frame = _timestep_embedding(torch.arange(frames, dtype=torch.float32, device=device), dim)
        site = _timestep_embedding(torch.arange(n, dtype=torch.float32, device=device), dim)
        return (frame[:, None] + site[None]) * (1 / math.sqrt(dim))

    def forward(self, x: torch.Tensor, t: torch.Tensor | float, context: torch.Tensor | None = None) -> torch.Tensor:
        """(B, C, F, H, W), (B,) or scalar timestep -> a prediction of the same
        shape and dtype.  ``context`` (B, T_txt, context_dim) feeds the
        cross-attention of a conditioned model; None on a conditioned model
        takes the learned null row (the guidance's unconditional branch)."""
        c = self.config
        dtype = c.compute_dtype
        B, _C, frames, H, W = x.shape
        t = torch.as_tensor(t, device=x.device)
        if t.ndim == 0:
            t = t.expand(B)
        if c.context_dim:
            if context is None:
                context = self.null_ctx[None].expand(B, 1, c.context_dim)
            context = context.to(dtype)
        elif context is not None:
            raise ValueError("context= needs VideoDiTConfig(context_dim=...)")

        patches = self.patchify(x)
        n = patches.shape[2]
        posemb = self._posemb(frames, n, x.device)
        if c.sequence_parallel:  # this rank's frames
            _group, size, rank = axis_group(self.mesh, c.sp_axis)
            if frames % size or n % size:
                raise ValueError(
                    f"frames ({frames}) and sites ({n}) must each divide the {c.sp_axis!r} axis size ({size})"
                )
            patches, posemb = patches.chunk(size, dim=1)[rank], posemb.chunk(size, dim=0)[rank]
        whole, frames = frames, patches.shape[1]
        tokens = _dense(self.patch_in, patches.to(dtype), dtype)
        tokens = (tokens + posemb.to(dtype)).reshape(B, frames * n, c.dim)
        temb = _timestep_embedding(t, 256)
        temb = F.silu(_dense(self.t_mlp2, F.silu(_dense(self.t_mlp1, temb.to(dtype), dtype)), dtype))

        for block in self.blocks:
            if c.remat and torch.is_grad_enabled():
                ctx_fn = _DOTS_CONTEXT if c.remat == "dots" else noop_context_fn
                tokens = checkpoint(block, tokens, temb, context, frames, n, use_reentrant=False, context_fn=ctx_fn)
            else:
                tokens = block(tokens, temb, context, frames, n)

        shift, scale = _dense(self.final_mod, temb, dtype).chunk(2, dim=-1)
        out = _dense(self.final_out, adaln_modulate(tokens, shift, scale), dtype).reshape(B, frames, n, -1)
        if c.sequence_parallel:
            out = gather(self.mesh, out, dim=1, axis=c.sp_axis)
        return self.unpatchify(out, whole, H, W).to(x.dtype)

    apply = forward

    def quantize_params(self) -> VideoDiT:
        """The int8 serving model, the JAX package's recipe: the block
        products as per-channel int8 with dynamic per-row activation scales
        (kernel B6); the conditioning pathway and the patch projections stay
        as they are and are shared with this model.  Serving only."""
        return _int8_copy(self, frozenset({"ada", "final_mod", "t_mlp1", "t_mlp2", "patch_in", "final_out"}))

    def param_spec(self, quantized: bool = False) -> dict:
        """The JAX package's megatron specs over ``tp``: the spatial, temporal and cross qkv (q_x, kv_c)
        and mlp_in column-parallel, their projections and mlp_out row-parallel, the rest replicated;
        int8's with ``quantized``."""
        col, row, rep = tensor_parallel.dense_specs(quantized)
        block = {"qkv_s": col, "proj_s": row, "qkv_t": col, "proj_t": row, "mlp_in": col, "mlp_out": row, "ada": rep}
        if self.config.context_dim:
            block.update(q_x=col, kv_c=col, proj_x=row)
        return {
            "patch_in": rep,
            "t_mlp1": rep,
            "t_mlp2": rep,
            "final_mod": rep,
            "final_out": rep,
            **({"null_ctx": tensor_parallel.P()} if self.config.context_dim else {}),
            "blocks": [dict(block) for _ in range(self.config.depth)],
        }

    def _guided(self, x: torch.Tensor, t: Any, ctx: torch.Tensor, scale: float, cfg_batched: bool) -> torch.Tensor:
        "Classifier-free guidance against the learned null row: two forwards in turn, or one doubled batch."
        B = x.shape[0]
        if not cfg_batched:
            return guided_mix(self(x, t, ctx), self(x, t), scale)
        t = torch.as_tensor(t, device=x.device).expand(B)
        null = self.null_ctx[None].expand(B, ctx.shape[1], ctx.shape[2]).to(ctx.dtype)
        both = self(torch.cat([x, x]), torch.cat([t, t]), torch.cat([ctx, null]))
        return guided_mix(both[:B], both[B:], scale)

    def as_sampleable(
        self, context: torch.Tensor | None = None, guidance_scale: float = 1.0, cfg_batched: bool = False
    ) -> Callable[[torch.Tensor, Any, Any, Any], torch.Tensor]:
        """Adapter to the sampling closure signature (x, t, sigma, alpha).
        With ``context`` and ``guidance_scale != 1`` the closure runs
        classifier-free guidance against the learned null context, as two
        sequential forwards (``cfg_batched=True``: one doubled batch)."""

        def model_fn(x: torch.Tensor, t: Any, s: Any, a: Any) -> torch.Tensor:
            if context is None:
                return self(x, t)
            ctx = per_item(context, x.shape[0], 2)
            if guidance_scale == 1.0:
                return self(x, t, ctx)
            return self._guided(x, t, ctx, guidance_scale, cfg_batched)

        return model_fn

    def as_served(
        self, guidance_scale: float = 1.0, cfg_batched: bool = False
    ) -> Callable[[torch.Tensor, Any, Any, Any, Any], torch.Tensor]:
        """The conditioned-serving closure ``(x, t, sigma, alpha, context)`` for
        ``ServingEngine(conditioned=True)``: each request's ``(T_txt, D)``
        context stacked to ``(B, T_txt, D)``; guidance as :meth:`as_sampleable`."""

        def model_fn(x: torch.Tensor, t: Any, s: Any, a: Any, context: torch.Tensor | None = None) -> torch.Tensor:
            if context is None or guidance_scale == 1.0:
                return self(x, t, context)
            return self._guided(x, t, context.to(x.dtype), guidance_scale, cfg_batched)

        return model_fn


def random_param_tree(config: VideoDiTConfig, seed: int) -> dict:
    """A JAX-layout parameter tree with EVERY weight and bias drawn at random
    from a numpy seed (normal weights scaled by ``1/sqrt(d_in)``, normal
    biases scaled by 0.1, a ``0.02 * N(0, 1)`` null row): the adaLN-zero
    initialisation would make a fresh model output exactly 0."""
    rng = np.random.default_rng(seed)
    c = config

    def dense(d_in: int, d_out: int) -> dict:
        w = rng.standard_normal((d_in, d_out), dtype=np.float32) / np.float32(math.sqrt(d_in))
        return {"w": w, "b": rng.standard_normal(d_out, dtype=np.float32) * np.float32(0.1)}

    patch_dim = c.channels * c.patch * c.patch
    branches = 4 if c.context_dim else 3
    tree: dict = {
        "patch_in": dense(patch_dim, c.dim),
        "t_mlp1": dense(256, c.dim),
        "t_mlp2": dense(c.dim, c.dim),
        "final_mod": dense(c.dim, 2 * c.dim),
        "final_out": dense(c.dim, patch_dim),
        "blocks": [],
    }
    if c.context_dim:
        tree["null_ctx"] = rng.standard_normal((1, c.context_dim), dtype=np.float32) * np.float32(0.02)
    for _ in range(c.depth):
        block = {
            "qkv_s": dense(c.dim, 3 * c.dim),
            "proj_s": dense(c.dim, c.dim),
            "qkv_t": dense(c.dim, 3 * c.dim),
            "proj_t": dense(c.dim, c.dim),
            "mlp_in": dense(c.dim, c.mlp_ratio * c.dim),
            "mlp_out": dense(c.mlp_ratio * c.dim, c.dim),
            "ada": dense(c.dim, 3 * branches * c.dim),
        }
        if c.context_dim:
            block.update(q_x=dense(c.dim, c.dim), kv_c=dense(c.context_dim, 2 * c.dim), proj_x=dense(c.dim, c.dim))
        tree["blocks"].append(block)
    return tree


def video_dit_forward_flops(
    config: VideoDiTConfig, batch: int, frames: int, h: int, w: int, txt_tokens: int = 0
) -> float:
    "Analytic matmul FLOPs of one forward (factorized attention counted exactly), the JAX package's count."
    c = config
    n = (h // c.patch) * (w // c.patch)
    s = frames * n
    d = c.dim
    branches = 4 if c.context_dim else 3
    total = 0.0
    # per block: 2 qkv (3d) + 2 proj + mlp in/out + ada head
    total += c.depth * 2.0 * batch * s * d * d * (2 * (3 + 1) + 2 * c.mlp_ratio)
    total += c.depth * 2.0 * batch * d * 3 * branches * d
    if c.context_dim and txt_tokens:
        # cross branch: q_x + proj_x on s tokens, kv_c on text tokens, scores + combine against txt_tokens keys
        total += c.depth * 2.0 * batch * s * d * d * 2
        total += c.depth * 2.0 * batch * txt_tokens * c.context_dim * 2 * d
        total += c.depth * 4.0 * batch * s * txt_tokens * d
    # factorized attention: scores + combine for each axis
    total += c.depth * batch * (4.0 * frames * n * n * d + 4.0 * n * frames * frames * d)
    patch_dim = c.channels * c.patch * c.patch
    total += 2.0 * batch * s * patch_dim * d * 2  # patch_in + final_out
    # conditioning pathway (per batch row): t_mlp1, t_mlp2, final_mod
    total += 2.0 * batch * (256 * d + d * d + d * 2 * d)
    return total
