"""The text-conditioned dual-stream diffusion transformer (MMDiT, SD3) as a PyTorch module.

The same network as the JAX package's ``models/mmdit.py``, parameter for
parameter (arXiv 2403.03206; diffusers ``SD3Transformer2DModel`` through
``import_weights.sd3_mmdit``): image patches and text tokens run as two
residual streams with their own weights and meet in ONE joint attention a
block, over the ``[image, text]`` sequence (Flux's order is the other way
round).  Each stream's adaLN-zero modulation runs on kernel K3; SD3.5's
per-head RMS qk-norm on B7 with identity rotation tables (cos 1, sin 0:
the rotation is exact and B7 reduces to the plain RMS norm), in place on
the q/k thirds of each qkv product; the joint attention at head dim 64
(every SD3 width) on B10's body over the joint qkv's ``chunk(3)`` views,
at head dim 128 on K2.  ``final_txt_pre_only`` (SD3's ``context_pre_only``)
gives the last block a text stream that only feeds the attention;
``dual_attention_layers`` (SD3.5-medium) a second self-attention on the
image stream, modulated from the block's input.

Two conditioning wirings: ``pooled_dim > 0`` is the published SD3 one
(pooled CLIP vector and timestep through separate two-layer MLPs, every
modulation reading ``silu(t_emb + pooled_emb)``, the context passed through
as it is); ``pooled_dim == 0`` the JAX package's native one (pooled text =
the context's mean, a learned null context padding or truncating to
``context_tokens``).

:meth:`MMDiT.load_jax_params` carries the JAX package's tree across and
:meth:`MMDiT.param_tree` carries it back.  Dense layers live in the
``dtype`` the model is built in; RMS gains, ``ctx_null`` and ``pos_embed``
stay float32.

Sequence parallelism (``attention="ring"|"ulysses"``, ``mesh=``) keeps both
residual streams token-sharded over the mesh's ``sp`` axis from the
embedding to the final layer, as the JAX package does: each rank holds its
contiguous range of the image tokens (and their position-table rows) and
of the text tokens, every dense layer and B7's qk-norm (identity tables of
its own rows) run on the shard, the joint attention is
:func:`~skrample_tpu_torch.parallel.joint_sp_attention` over the two
streams in the ``[image, text]`` order, a dual attention the same scheme
over the image stream alone, and the final layer's output is all-gathered.
On a ``dp`` x ``sp`` mesh the input is the rank's ``dp`` chunk of the batch,
as for the DiT.  On a mesh with a ``tp`` axis both streams' layers are cut
as :meth:`MMDiT.param_spec` splits them (``parallel/tensor_parallel.py``),
``heads / tp`` heads a rank.  :meth:`MMDiT.apply_pipelined` runs uniform
blocks as GPipe stages over a ``pp`` axis (``parallel/pipeline_stages.py``).
"""

from __future__ import annotations

import functools
import math
from collections.abc import Callable, Iterator
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, noop_context_fn

from ..ops._cuda import resolve_device
from ..ops.adaln import adaln_modulate
from ..ops.rope import fused_rope_qk_norm
from ..parallel import gather, joint_sp_attention, tensor_parallel
from ..parallel.pipeline_stages import model_stages, run_stages
from ..parallel.ring_attention import axis_group, ring_attention
from ..parallel.ulysses import ulysses_attention
from . import _tree
from .conditioning import doubled_t, guided_mix, per_item
from .dit import _DOTS_CONTEXT, _dense, _int8_copy, _timestep_embedding
from .flux import _FLASH_HEAD_DIMS, _attention, _gain, _gelu, _linear

_ZERO_INIT = frozenset({"ada", "final_mod", "final_out"})
_QK_EPS = 1e-6


@dataclass(frozen=True)
class MMDiTConfig:
    patch: int = 2
    channels: int = 4
    dim: int = 512
    depth: int = 8
    heads: int = 4
    mlp_ratio: int = 4
    context_dim: int = 512
    "Width of the incoming text-encoder features."
    context_tokens: int = 128
    "Static text-token count of the native wiring (a multiple of 128); inputs are padded or truncated to it."
    compute_dtype: torch.dtype = torch.bfloat16
    attention: str = "flash"
    """``"flash"`` (B10 at head dim 64, K2 at 128; other head dims are
    refused: use ``"full"``), ``"full"`` (plain attention, any head dim), or
    the sequence-parallel ``"ring"`` (B11 a hop) and ``"ulysses"`` (B9 on
    each rank's head shard), which need ``MMDiT(config, mesh=...)`` with the
    ``sp_axis`` and serve (a gradient through them raises)."""
    sp_axis: str = "sp"
    remat: bool | str = False
    "Recompute each block's activations in the backward: ``True`` or ``\"dots\"`` (as the DiT)."
    pooled_dim: int = 0
    "> 0: the published SD3 wiring (``pooled`` becomes a required input); 0: the native wiring."
    pos_embed_max: int = 0
    "> 0: a (max, max) patch-grid position table, centre-cropped to the latent's grid (SD3's cropped pos-embed)."
    final_txt_pre_only: bool = False
    "SD3's ``context_pre_only``: the last block's text stream feeds the attention and is never updated."
    qk_norm: bool = False
    "SD3.5's per-head RMS norm of q and k (learned (head_dim,) gains, eps 1e-6)."
    dual_attention_layers: tuple[int, ...] = ()
    "SD3.5-medium: blocks with a second image self-attention, modulated from the block's input."

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def sd3_wiring(self) -> bool:
        return self.pooled_dim > 0


def _sincos_2d(side: int, dim: int) -> torch.Tensor:
    """Factorized 2-D sinusoidal position table ``(side * side, dim)``: half
    the features encode the row, half the column (float32)."""
    half = dim // 2
    pos = torch.arange(side, dtype=torch.float32)
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half // 2, dtype=torch.float32) / (half // 2))
    args = pos[:, None] * freqs[None]
    axis = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)  # (side, half)
    rows = axis[:, None, :].expand(side, side, half)
    cols = axis[None, :, :].expand(side, side, half)
    return torch.cat([rows, cols], dim=-1).reshape(side * side, dim)


class _MMStream(nn.Module):
    """One stream of a block.  ``groups`` modulation groups: 6 ([shift,
    gate, scale] x (attention, MLP)), 9 with a dual attention's third, 2
    ([shift, scale]) for a pre-only text stream, which has no proj or MLP."""

    def __init__(self, c: MMDiTConfig, dtype: torch.dtype, groups: int) -> None:
        super().__init__()
        d = c.dim
        self.ada = _linear(d, groups * d, dtype)
        self.qkv = _linear(d, 3 * d, dtype)
        if groups != 2:
            self.proj = _linear(d, d, dtype)
            self.mlp_in = _linear(d, c.mlp_ratio * d, dtype)
            self.mlp_out = _linear(c.mlp_ratio * d, d, dtype)
        if groups == 9:
            self.qkv2 = _linear(d, 3 * d, dtype)
            self.proj2 = _linear(d, d, dtype)
        if c.qk_norm:
            self.q_norm = _gain(c.head_dim)
            self.k_norm = _gain(c.head_dim)
            if groups == 9:
                self.q_norm2 = _gain(c.head_dim)
                self.k_norm2 = _gain(c.head_dim)


class _MMBlock(nn.Module):
    "One dual-stream block: per-stream adaLN-zero, one joint attention over [image, text]."

    def __init__(self, c: MMDiTConfig, dtype: torch.dtype, index: int, mesh: Any = None) -> None:
        super().__init__()
        self.config = c
        self.mesh = mesh
        self.dual = index in c.dual_attention_layers
        self.txt_pre_only = c.final_txt_pre_only and index == c.depth - 1
        self.img = _MMStream(c, dtype, 9 if self.dual else 6)
        self.txt = _MMStream(c, dtype, 2 if self.txt_pre_only else 6)

    def _norm(self, qkv: torch.Tensor, q_gain: torch.Tensor, k_gain: torch.Tensor, tables: Callable) -> torch.Tensor:
        "The qk RMS norm (kernel B7 with identity tables), in place where no gradient is wanted."
        cos, sin = tables(qkv.shape[1])
        return fused_rope_qk_norm(qkv, q_gain, k_gain, cos, sin, self.config.heads, _QK_EPS)

    def _self_attention(self, qkv: torch.Tensor) -> torch.Tensor:
        "The dual attention over the image stream: on a mesh, the sequence-parallel scheme over its shards."
        c = self.config
        if c.attention not in ("ring", "ulysses"):
            return _attention(qkv, c)
        B, n, _ = qkv.shape
        q, k, v = (part.reshape(B, n, c.heads, c.head_dim).transpose(1, 2) for part in qkv.chunk(3, dim=-1))
        attend = ring_attention if c.attention == "ring" else ulysses_attention
        return attend(q, k, v, self.mesh, c.sp_axis).transpose(1, 2).reshape(B, n, c.dim)

    def forward(
        self, img: torch.Tensor, txt: torch.Tensor, cond: torch.Tensor, tables: Callable
    ) -> tuple[torch.Tensor, torch.Tensor]:
        c = self.config
        dense = functools.partial(_dense, dtype=c.compute_dtype)
        mods_i = dense(self.img.ada, cond).chunk(9 if self.dual else 6, dim=-1)
        si_a, gi_a, ci_a, si_m, gi_m, ci_m = mods_i[:6]
        if self.txt_pre_only:
            st_a, ct_a = dense(self.txt.ada, cond).chunk(2, dim=-1)
        else:
            st_a, gt_a, ct_a, st_m, gt_m, ct_m = dense(self.txt.ada, cond).chunk(6, dim=-1)

        qkv_img = dense(self.img.qkv, adaln_modulate(img, si_a, ci_a))
        qkv_txt = dense(self.txt.qkv, adaln_modulate(txt, st_a, ct_a))
        if c.qk_norm:
            qkv_img = self._norm(qkv_img, self.img.q_norm, self.img.k_norm, tables)
            qkv_txt = self._norm(qkv_txt, self.txt.q_norm, self.txt.k_norm, tables)
        if self.dual:  # the second attention modulates the block's INPUT: its qkv comes before img moves
            si_a2, gi_a2, ci_a2 = mods_i[6:]
            qkv2 = dense(self.img.qkv2, adaln_modulate(img, si_a2, ci_a2))
            if c.qk_norm:
                qkv2 = self._norm(qkv2, self.img.q_norm2, self.img.k_norm2, tables)
        if c.attention in ("ring", "ulysses"):
            out_img, out_txt = joint_sp_attention(qkv_img, qkv_txt, c.heads, self.mesh, c.sp_axis, c.attention)
        else:
            N = img.shape[1]
            out = _attention(torch.cat([qkv_img, qkv_txt], dim=1), c)
            out_img, out_txt = out[:, :N], out[:, N:]
        img = img + gi_a[:, None] * dense(self.img.proj, out_img)
        if self.dual:
            img = img + gi_a2[:, None] * dense(self.img.proj2, self._self_attention(qkv2))

        h = adaln_modulate(img, si_m, ci_m)
        img = img + gi_m[:, None] * dense(self.img.mlp_out, _gelu(dense(self.img.mlp_in, h)))
        if self.txt_pre_only:
            return img, txt
        txt = txt + gt_a[:, None] * dense(self.txt.proj, out_txt)
        h = adaln_modulate(txt, st_m, ct_m)
        txt = txt + gt_m[:, None] * dense(self.txt.mlp_out, _gelu(dense(self.txt.mlp_in, h)))
        return img, txt


class MMDiT(nn.Module):
    """``MMDiT(config)(x, t, context, pooled=None)``: (B, C, H, W) latents,
    (B,) or scalar timestep, (B, M, context_dim) text features (None: the
    native wiring's learned null), (B, pooled_dim) pooled CLIP vector (the
    SD3 wiring only) -> a prediction of the latents' shape and dtype.

    Built on ``device`` (CUDA unless the caller asks for the CPU) with dense
    layers in ``dtype`` and the JAX package's initialisation drawn from
    ``generator`` (seed 0 on the CPU when omitted); see
    :meth:`reset_parameters`."""

    def __init__(
        self,
        config: MMDiTConfig = MMDiTConfig(),
        mesh: Any = None,
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        c = config
        if c.attention not in ("full", "flash", "ring", "ulysses"):
            raise ValueError(f"unknown attention kind {c.attention!r}")
        if c.attention in ("ring", "ulysses"):
            if mesh is None:
                raise ValueError(
                    f"MMDiTConfig(attention={c.attention!r}) needs MMDiT(config, mesh=...) with the sp axis"
                )
            axis_group(mesh, c.sp_axis)  # raises on a mesh without the axis
        elif mesh is not None and "tp" not in (mesh.mesh_dim_names or ()):
            raise ValueError(
                f"MMDiT(mesh=...) with attention={c.attention!r} needs a 'tp' mesh axis (tensor parallelism; "
                "sequence parallelism is attention='ring' or 'ulysses')"
            )
        if c.attention == "flash" and c.head_dim not in _FLASH_HEAD_DIMS:
            raise NotImplementedError(
                f"attention='flash' takes head_dim {' or '.join(map(str, _FLASH_HEAD_DIMS))}, got {c.head_dim}: "
                "use attention='full'"
            )
        if not c.sd3_wiring and c.context_tokens % 128:
            raise ValueError("context_tokens must be a multiple of 128 (the JAX package's static tiling)")
        if c.remat not in (False, True, "dots"):
            raise ValueError(f"remat must be bool or 'dots', got {c.remat!r}")
        self.config = c
        self.mesh = mesh
        patch_dim = c.channels * c.patch * c.patch
        self.patch_in = _linear(patch_dim, c.dim, dtype)
        self.ctx_in = _linear(c.context_dim, c.dim, dtype)
        self.t_mlp1 = _linear(256, c.dim, dtype)
        self.t_mlp2 = _linear(c.dim, c.dim, dtype)
        self.final_mod = _linear(c.dim, 2 * c.dim, dtype)
        self.final_out = _linear(c.dim, patch_dim, dtype)
        if c.sd3_wiring:
            self.pool_mlp1 = _linear(c.pooled_dim, c.dim, dtype)
            self.pool_mlp2 = _linear(c.dim, c.dim, dtype)
        else:
            self.ctx_null = nn.Parameter(torch.empty(c.context_tokens, c.context_dim, device="meta"))
            self.pool_mlp = _linear(c.context_dim, c.dim, dtype)
        if c.pos_embed_max:
            self.pos_embed = nn.Parameter(torch.empty(c.pos_embed_max**2, c.dim, device="meta"))
        self.blocks = nn.ModuleList(_MMBlock(c, dtype, i, mesh) for i in range(c.depth))
        if tensor_parallel.tp_size(mesh) > 1:  # each rank holds its shard and runs heads / tp heads of both streams
            tensor_parallel.cut_on_meta(tensor_parallel.linears(self), self.param_spec(), mesh, self._tp_segments())
            for block in self.blocks:
                block.config = tensor_parallel.local_config(c, mesh)
        self.to_empty(device=resolve_device(device))
        self.reset_parameters(generator)

    def _tp_segments(self) -> dict[str, tuple[int, ...]]:
        "Every fused qkv's three parts (both streams, the dual attention's too), each split by heads."
        d = self.config.dim
        return {
            f"blocks.{i}.{stream}.{name}": (d, d, d)
            for i in range(self.config.depth)
            for stream in ("img", "txt")
            for name in ("qkv", "qkv2")
        }

    # -- parameters ------------------------------------------------------------

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None, noise: float = 0.0) -> None:
        """The JAX package's initialisation: normal weights scaled by
        ``1/sqrt(d_in)``, zero biases, zero ``ada``/``final_mod``/``final_out``
        (adaLN-zero: a fresh model outputs exactly 0), unit RMS gains, the
        null context ``0.02 N(0, 1)``, the position table the 2-D sinusoids;
        then, with ``noise``, ``noise * N(0, 1)`` added to every dense weight,
        bias and gain (Flux's recipe for random weights that exercise every
        path).  Drawn on ``generator``'s device (the CPU, seed 0, when
        omitted), one leaf at a time, then cast to the parameters' dtype."""
        gen = generator if generator is not None else torch.Generator().manual_seed(0)

        def normal(*shape: int) -> torch.Tensor:
            return torch.randn(shape, generator=gen, device=gen.device)

        for name, module in self.named_modules():
            if isinstance(module, nn.Linear):
                d_in, d_out = tensor_parallel.whole_features(module)
                zero = name.rpartition(".")[2] in _ZERO_INIT
                w = torch.zeros(d_in, d_out, device=gen.device) if zero else normal(d_in, d_out) / math.sqrt(d_in)
                b = torch.zeros(d_out, device=gen.device)
                if noise:
                    w += noise * normal(d_in, d_out)
                    b += noise * normal(d_out)
                tensor_parallel.load_dense(module, w, b)
        for name, param in self.named_parameters():
            leaf = name.rpartition(".")[2]
            if leaf.startswith(("q_norm", "k_norm")):
                g = torch.ones(param.shape, device=gen.device)
                param.copy_(g + noise * normal(*param.shape) if noise else g)
            elif leaf == "ctx_null":
                param.copy_(normal(*param.shape) * 0.02)
            elif leaf == "pos_embed":
                param.copy_(_sincos_2d(self.config.pos_embed_max, self.config.dim))

    def param_tree(self) -> dict:
        """The parameters as the JAX package's tree of float32 numpy arrays
        (``w`` ``(d_in, d_out)``, the transpose of ``nn.Linear``'s): the
        inverse of :meth:`load_jax_params`."""
        return _tree.param_tree(self)

    def load_jax_params(self, tree: dict) -> MMDiT:
        """Fill the module from the JAX package's parameter tree (as
        ``skrample_tpu.models.mmdit.MMDiT.init`` or ``import_weights.sd3_mmdit``
        lay it out, numpy or jax arrays).  Every key must be consumed and
        every shape must match."""
        tree = tensor_parallel.shard_params(tree, self.param_spec(), self.mesh, self._tp_segments())
        _tree.load_tree(self, tree, "MMDiT")
        return self

    def quantize_params(self) -> MMDiT:
        """The int8 serving model, the JAX package's recipe: every dense layer
        of at least 16384 weights as per-channel int8 with dynamic per-row
        activation scales (kernel B6), except the modulation heads and the
        conditioning pathway (``ada``, ``final_mod``, ``t_mlp1``, ``t_mlp2``,
        ``pool_mlp``, ``pool_mlp1``, ``pool_mlp2``, ``ctx_in``), which stay as
        they are and are shared with this model.  Serving only."""
        exclude = frozenset({"ada", "final_mod", "t_mlp1", "t_mlp2", "pool_mlp", "pool_mlp1", "pool_mlp2", "ctx_in"})
        return _int8_copy(self, exclude)

    def param_spec(self, quantized: bool = False) -> dict:
        """The JAX package's tensor-parallel specs over ``tp`` for both streams (qkv, qkv2 and mlp_in
        column-parallel, proj, proj2 and mlp_out row-parallel, the rest replicated; the pre-only text
        stream keeps its qkv and ada), int8's with ``quantized``."""
        col, row, rep = tensor_parallel.dense_specs(quantized)
        P = tensor_parallel.P
        c = self.config
        stream = {"qkv": col, "proj": row, "mlp_in": col, "mlp_out": row, "ada": rep}
        pre_stream: dict = {"qkv": dict(col), "ada": dict(rep)}
        if c.qk_norm:
            stream = {**stream, "q_norm": P(), "k_norm": P()}
            pre_stream = {**pre_stream, "q_norm": P(), "k_norm": P()}
        dual = {"qkv2": dict(col), "proj2": dict(row)} | ({"q_norm2": P(), "k_norm2": P()} if c.qk_norm else {})
        spec: dict = {
            "patch_in": rep,
            "ctx_in": rep,
            "t_mlp1": rep,
            "t_mlp2": rep,
            "final_mod": rep,
            "final_out": rep,
            "blocks": [
                {
                    "img": dict(stream) | (dual if i in c.dual_attention_layers else {}),
                    "txt": dict(pre_stream) if c.final_txt_pre_only and i == c.depth - 1 else dict(stream),
                }
                for i in range(c.depth)
            ],
        }
        if c.sd3_wiring:
            spec["pool_mlp1"] = rep
            spec["pool_mlp2"] = rep
        else:
            spec["ctx_null"] = P()
            spec["pool_mlp"] = rep
        if c.pos_embed_max:
            spec["pos_embed"] = P()
        return spec

    def apply_pipelined(
        self,
        x: torch.Tensor,
        t: torch.Tensor | float,
        mesh: Any,
        microbatch: int,
        context: torch.Tensor | None = None,
        pooled: torch.Tensor | None = None,
        axis: str = "pp",
        batch_axis: str | None = None,
    ) -> torch.Tensor:
        """Pipeline-parallel forward (GPipe over ``axis``; see :meth:`DiT.apply_pipelined
        <skrample_tpu_torch.models.dit.DiT.apply_pipelined>` for the schedule and ``batch_axis``): the
        ``(img, txt, cond)`` triple streams through the stages, both residual streams and the
        conditioning vector every block's modulations read.  Needs uniform blocks, as the JAX package:
        SD3's ``final_txt_pre_only`` last block and SD3.5-medium's ``dual_attention_layers`` give
        blocks of other structures."""
        c = self.config
        if c.final_txt_pre_only or c.dual_attention_layers:
            raise ValueError("pipeline parallelism needs uniform blocks (no final_txt_pre_only / dual attention)")
        B, _C, H, W = x.shape
        blocks, mb, group = model_stages(self.blocks, mesh, axis, batch_axis, B, microbatch)
        img, txt, cond = self._prelude(x, t, context, pooled)
        tables = functools.cache(functools.partial(_identity_tables, d=c.head_dim, device=x.device))

        def stage(_params: list[torch.Tensor], carry: tuple[torch.Tensor, ...]) -> tuple[torch.Tensor, ...]:
            im, tx, cd = carry
            for block in blocks:
                im, tx = block(im, tx, cd, tables)
            return im, tx, cd

        count = B // mb
        params = [p for block in blocks for p in block.parameters()]
        streams = tuple(a.reshape(count, mb, *a.shape[1:]) for a in (img, txt, cond))
        img_out, _txt, _cond = run_stages(stage, params, streams, group)
        return self._finalize(img_out.reshape(B, *img_out.shape[2:]), cond, H, W, x.dtype)

    # -- layout ----------------------------------------------------------------

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        "(B, C, H, W) -> (B, N, C * p * p)"
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

    def embed_context(self, context: torch.Tensor | None, batch: int) -> torch.Tensor:
        """(B, M, context_dim) features -> the native wiring's static (B,
        context_tokens, context_dim): truncated, or padded with the learned
        null; ``None`` is the unconditional branch (all null).  The SD3 wiring
        passes the context through and has no null."""
        c = self.config
        if c.sd3_wiring:
            if context is None:
                raise ValueError(
                    "SD3-wired MMDiT has no learned null context: pass the encoded "
                    "empty prompt as the unconditional context"
                )
            return context
        null = self.ctx_null.expand(batch, c.context_tokens, c.context_dim)
        if context is None:
            return null
        M = context.shape[1]
        if M >= c.context_tokens:
            return context[:, : c.context_tokens]
        return torch.cat([context, null[:, M:]], dim=1)

    # -- forward ---------------------------------------------------------------

    def forward(
        self,
        x: torch.Tensor,
        t: torch.Tensor | float,
        context: torch.Tensor | None = None,
        pooled: torch.Tensor | None = None,
    ) -> torch.Tensor:
        c = self.config
        _B, _C, H, W = x.shape
        img, txt, cond = self._prelude(x, t, context, pooled)
        tables = functools.cache(functools.partial(_identity_tables, d=c.head_dim, device=x.device))
        for block in self.blocks:
            if c.remat and torch.is_grad_enabled():
                ctx_fn = _DOTS_CONTEXT if c.remat == "dots" else noop_context_fn
                img, txt = checkpoint(block, img, txt, cond, tables, use_reentrant=False, context_fn=ctx_fn)
            else:
                img, txt = block(img, txt, cond, tables)
        return self._finalize(img, cond, H, W, x.dtype)

    apply = forward

    def _prelude(
        self, x: torch.Tensor, t: torch.Tensor | float, context: torch.Tensor | None, pooled: torch.Tensor | None
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The image and text streams (this rank's token shards under sequence parallelism) and the
        conditioning vector, ahead of the blocks."""
        c = self.config
        dtype = c.compute_dtype
        B, _C, H, W = x.shape
        if (pooled is not None) != c.sd3_wiring:
            raise ValueError("pooled= goes with MMDiTConfig(pooled_dim > 0), and is required there")
        t = torch.as_tensor(t, device=x.device)
        if t.ndim == 0:
            t = t.expand(B)
        context = self.embed_context(context, B).to(dtype)

        patches, ctx_rows = self.patchify(x), context
        sequence_parallel = c.attention in ("ring", "ulysses")
        shard = self._shard if sequence_parallel else lambda a, _stream: a
        img = _dense(self.patch_in, shard(patches, "a").to(dtype), dtype)
        if c.pos_embed_max:
            gh, gw = H // c.patch, W // c.patch
            table = self.pos_embed.view(c.pos_embed_max, c.pos_embed_max, c.dim)
            top, left = (c.pos_embed_max - gh) // 2, (c.pos_embed_max - gw) // 2
            rows = table[top : top + gh, left : left + gw].reshape(1, gh * gw, c.dim)
            img = img + shard(rows, "a")[0].to(dtype)
        txt = _dense(self.ctx_in, shard(ctx_rows, "b"), dtype)

        tfeat = _timestep_embedding(t, 256).to(dtype)
        if c.sd3_wiring:  # two linear-silu-linear MLPs summed; every consumer reads silu(t_emb + pooled_emb)
            temb = _dense(self.t_mlp2, F.silu(_dense(self.t_mlp1, tfeat, dtype)), dtype)
            pemb = _dense(self.pool_mlp2, F.silu(_dense(self.pool_mlp1, pooled.to(dtype), dtype)), dtype)
            cond = F.silu(temb + pemb)
        else:
            temb = _dense(self.t_mlp1, tfeat, dtype)
            pool = _dense(self.pool_mlp, context.mean(dim=1), dtype)
            cond = F.silu(_dense(self.t_mlp2, F.silu(temb + pool), dtype))
        return img, txt, cond

    def _finalize(self, img: torch.Tensor, cond: torch.Tensor, H: int, W: int, out_dtype: torch.dtype) -> torch.Tensor:
        "Final modulation, out-projection (the token shards gathered under sequence parallelism), unpatchify."
        c = self.config
        shift, scale = _dense(self.final_mod, cond, c.compute_dtype).chunk(2, dim=-1)
        out = _dense(self.final_out, adaln_modulate(img, shift, scale), c.compute_dtype)
        if c.attention in ("ring", "ulysses"):
            out = gather(self.mesh, out, dim=1, axis=c.sp_axis)
        return self.unpatchify(out, H, W).to(out_dtype)

    def _shard(self, a: torch.Tensor, stream: str) -> torch.Tensor:
        """This rank's contiguous token range of a ``(B, n, ...)`` stream over the ``sp`` axis; a token
        count the axis does not divide raises the JAX joint attention's ``ValueError``."""
        axis = self.config.sp_axis
        _group, size, rank = axis_group(self.mesh, axis)
        if a.shape[1] % size:
            raise ValueError(f"stream {stream} tokens ({a.shape[1]}) must divide the {axis!r} axis size ({size})")
        return a.chunk(size, dim=1)[rank]

    # -- sampling and serving ----------------------------------------------------

    def as_sampleable(
        self,
        context: torch.Tensor | None = None,
        guidance_scale: float = 1.0,
        pooled: torch.Tensor | None = None,
        uncond_context: torch.Tensor | None = None,
        uncond_pooled: torch.Tensor | None = None,
    ) -> Callable[[torch.Tensor, Any, Any, Any], torch.Tensor]:
        """Sampling closure ``(x, t, sigma, alpha)`` with the conditioning
        bound (a single prompt serves any batch).  ``guidance_scale != 1``
        runs classifier-free guidance, both branches in one batched forward:
        against the learned null natively, against ``uncond_context`` /
        ``uncond_pooled`` (the encoded empty prompt) with the SD3 wiring."""
        sd3 = self.config.sd3_wiring
        if context is None or guidance_scale == 1.0:

            def model_fn(x: torch.Tensor, t: Any, s: Any, a: Any) -> torch.Tensor:
                B = x.shape[0]
                ctx = None if context is None else per_item(context, B, 2)
                pool = None if pooled is None else per_item(pooled, B, 1)
                return self(x, t, ctx, pooled=pool)

            return model_fn

        if sd3 and (uncond_context is None or uncond_pooled is None):
            raise ValueError("SD3-wired guidance needs uncond_context= and uncond_pooled=")

        def guided_fn(x: torch.Tensor, t: Any, s: Any, a: Any) -> torch.Tensor:
            B = x.shape[0]
            if sd3:
                ctx_c, ctx_u = per_item(context, B, 2), per_item(uncond_context, B, 2)
                pool = torch.cat([per_item(pooled, B, 1), per_item(uncond_pooled, B, 1)])
            else:
                ctx_c, ctx_u = self.embed_context(per_item(context, B, 2), B), self.embed_context(None, B)
                pool = None
            both = self(torch.cat([x, x]), doubled_t(t, B), torch.cat([ctx_c, ctx_u]), pooled=pool)
            return guided_mix(both[:B], both[B:], guidance_scale)

        return guided_fn

    def as_served(self, guidance_scale: float = 1.0, per_request_scale: bool = False) -> Callable[..., torch.Tensor]:
        """Conditioned-serving closure ``(x, t, sigma, alpha, context)`` for
        ``ServingEngine(conditioned=True)`` over the native wiring: each
        request submits its context and the engine stacks them; ``None`` is
        the unconditional branch.  With ``guidance_scale != 1`` CFG runs
        against the learned null, both branches in one forward.
        ``per_request_scale=True``: each request's context is the pair
        ``(context, scale)`` and every item mixes with its own scale
        (``guidance_scale`` is then ignored)."""

        def model_fn(x: torch.Tensor, t: Any, sigma: Any, alpha: Any, context: Any = None) -> torch.Tensor:
            B = x.shape[0]
            scale = None
            if per_request_scale:
                if context is None:
                    raise ValueError("per_request_scale serving requires context=(context, scale) per request")
                context, scale = context
            if context is None or (scale is None and guidance_scale == 1.0):
                return self(x, t, context)
            both = self(
                torch.cat([x, x]),
                doubled_t(t, B),
                torch.cat([self.embed_context(context, B), self.embed_context(None, B)]),
            )
            c_out, u_out = both[:B], both[B:]
            if scale is None:
                return guided_mix(c_out, u_out, guidance_scale)
            s = torch.as_tensor(scale, device=c_out.device).reshape((B,) + (1,) * (c_out.ndim - 1)).to(c_out.dtype)
            return u_out + s * (c_out - u_out)

        return model_fn


def _identity_tables(n: int, d: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    "(cos, sin) = (1, 0) of shape (n, d // 2), float32: B7's rotation reduces to the identity exactly."
    return (
        torch.ones((n, d // 2), dtype=torch.float32, device=device),
        torch.zeros((n, d // 2), dtype=torch.float32, device=device),
    )


def _dense_leaves(c: MMDiTConfig) -> Iterator[tuple[str, int, int]]:
    "(tree path, d_in, d_out) of every dense layer, in the JAX tree's layout."
    d, pd = c.dim, c.channels * c.patch * c.patch
    yield from (("patch_in", pd, d), ("ctx_in", c.context_dim, d), ("t_mlp1", 256, d), ("t_mlp2", d, d))
    yield from (("final_mod", d, 2 * d), ("final_out", d, pd))
    if c.sd3_wiring:
        yield from (("pool_mlp1", c.pooled_dim, d), ("pool_mlp2", d, d))
    else:
        yield "pool_mlp", c.context_dim, d
    for i in range(c.depth):
        dual = i in c.dual_attention_layers
        for stream in ("img", "txt"):
            pre_only = stream == "txt" and c.final_txt_pre_only and i == c.depth - 1
            groups = 2 if pre_only else 9 if dual and stream == "img" else 6
            yield f"blocks.{i}.{stream}.ada", d, groups * d
            yield f"blocks.{i}.{stream}.qkv", d, 3 * d
            if not pre_only:
                yield from ((f"blocks.{i}.{stream}.proj", d, d), (f"blocks.{i}.{stream}.mlp_in", d, c.mlp_ratio * d))
                yield f"blocks.{i}.{stream}.mlp_out", c.mlp_ratio * d, d
            if groups == 9:
                yield from ((f"blocks.{i}.img.qkv2", d, 3 * d), (f"blocks.{i}.img.proj2", d, d))


def random_param_tree(config: MMDiTConfig, seed: int) -> dict:
    """A JAX-layout MMDiT tree with EVERY leaf random from a numpy seed
    (normal weights scaled by ``1/sqrt(d_in)``, normal biases scaled by 0.1,
    RMS gains ``1 + 0.1 N(0, 1)``, the null context ``0.02 N(0, 1)``, the
    position table ``0.1 N(0, 1)``): the adaLN-zero initialisation would
    make both packages output exactly 0."""
    rng = np.random.default_rng(seed)
    c = config
    tree: dict = {"blocks": [{"img": {}, "txt": {}} for _ in range(c.depth)]}
    for path, d_in, d_out in _dense_leaves(c):
        w = rng.standard_normal((d_in, d_out), dtype=np.float32) / np.float32(math.sqrt(d_in))
        b = rng.standard_normal(d_out, dtype=np.float32) * np.float32(0.1)
        _tree._put(tree, path.split("."), {"w": w, "b": b})
    if c.qk_norm:
        for i, block in enumerate(tree["blocks"]):
            for stream, node in block.items():
                dual = stream == "img" and i in c.dual_attention_layers
                for name in ("q_norm", "k_norm", "q_norm2", "k_norm2")[: 4 if dual else 2]:
                    node[name] = np.float32(1) + rng.standard_normal(c.head_dim, dtype=np.float32) * np.float32(0.1)
    if not c.sd3_wiring:
        tree["ctx_null"] = rng.standard_normal((c.context_tokens, c.context_dim), dtype=np.float32) * np.float32(0.02)
    if c.pos_embed_max:
        tree["pos_embed"] = rng.standard_normal((c.pos_embed_max**2, c.dim), dtype=np.float32) * np.float32(0.1)
    return tree


def mmdit_forward_flops(config: MMDiTConfig, batch: int, h: int, w: int) -> float:
    "Analytic matmul FLOPs of one forward (the JAX package's count; joint attention counted exactly)."
    c = config
    n_img = (h // c.patch) * (w // c.patch)
    n_txt = c.context_tokens
    n = n_img + n_txt
    d = c.dim
    total = 0.0
    for tokens in (n_img, n_txt):  # qkv + proj + mlp per block, per stream
        total += c.depth * batch * tokens * d * d * (6 + 2 + 2 * c.mlp_ratio + 2 * c.mlp_ratio)
    total += c.depth * batch * 2 * (2.0 * d * 6 * d)  # ada heads (per batch row, both streams)
    total += 4.0 * batch * c.depth * n * n * d  # joint attention scores + combine
    patch_dim = c.channels * c.patch * c.patch
    total += 2.0 * batch * n_img * patch_dim * d * 2  # patch_in + final_out
    total += 2.0 * batch * n_txt * c.context_dim * d  # ctx_in
    total += 2.0 * batch * (c.context_dim * d + 256 * d + d * d + d * 2 * d)  # pool_mlp, t_mlp1, t_mlp2, final_mod
    return total
