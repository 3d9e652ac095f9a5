"""The T5-class bidirectional text encoder as a PyTorch module (the JAX
package's ``models/t5_encoder.py``): SD3's third prompt tower.

T5 v1.1: relative-position-bias attention (no absolute positions, scores
left unscaled), RMS norms in float32, bias-free projections, and a gated
GELU feed-forward (``gated=False``: the original ReLU one).  The relative
bias is bucketed on the host (numpy, as in the JAX package) and added to
every layer's scores.  Attention is plain batched products with float32
scores: encoder contexts are 77-512 tokens.

:meth:`T5Encoder.load_jax_params` carries the JAX tree across
(``import_weights.t5_encoder`` builds one from a transformers state dict)
and :meth:`T5Encoder.param_tree` carries it back.  On a mesh with a ``tp``
axis each rank keeps its shard of the projections
:meth:`T5Encoder.param_spec` splits and its heads' columns of the relative
bias (``parallel/tensor_parallel.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops._cuda import resolve_device
from ..parallel import tensor_parallel
from . import _tree
from .text_encoder import _ids


@dataclass(frozen=True)
class T5EncoderConfig:
    vocab_size: int = 32128
    dim: int = 512
    "Model width (``d_model``)."
    head_dim: int = 64
    "Per-head width (``d_kv``); T5 decouples it from ``dim``."
    heads: int = 8
    ff_dim: int = 1024
    depth: int = 6
    gated: bool = True
    '``True``: the v1.1 gated-gelu FF (``wi_0``/``wi_1``); ``False``: relu.'
    rel_buckets: int = 32
    rel_max_distance: int = 128
    ln_eps: float = 1e-6
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def inner_dim(self) -> int:
        return self.heads * self.head_dim


def _relative_position_bucket(relative_position: np.ndarray, num_buckets: int, max_distance: int) -> np.ndarray:
    "T5's bidirectional log-bucketing of position deltas (host-side, static)."
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, num_buckets - 1)
    return ret + np.where(n < max_exact, n, large)


def _matrix(d_in: int, d_out: int, dtype: torch.dtype) -> nn.Linear:
    "A bias-free projection: the JAX tree's bare (d_in, d_out) matrix."
    return nn.Linear(d_in, d_out, bias=False, device="meta", dtype=dtype)


class _T5Block(nn.Module):
    def __init__(self, c: T5EncoderConfig, dtype: torch.dtype) -> None:
        super().__init__()
        self.q = _matrix(c.dim, c.inner_dim, dtype)
        self.k = _matrix(c.dim, c.inner_dim, dtype)
        self.v = _matrix(c.dim, c.inner_dim, dtype)
        self.o = _matrix(c.inner_dim, c.dim, dtype)
        self.ln_attn = nn.Parameter(torch.empty(c.dim, device="meta"))
        self.ln_ff = nn.Parameter(torch.empty(c.dim, device="meta"))
        if c.gated:
            self.wi_0 = _matrix(c.dim, c.ff_dim, dtype)
            self.wi_1 = _matrix(c.dim, c.ff_dim, dtype)
        else:
            self.wi = _matrix(c.dim, c.ff_dim, dtype)
        self.wo = _matrix(c.ff_dim, c.dim, dtype)


def _mm(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` in ``dtype`` (the JAX package's ``x @ w.astype(dtype)``); a tensor-parallel layer's
    product through ``tensor_parallel.product``."""
    if getattr(layer, "tp", None) is not None:
        return tensor_parallel.product(layer, x, dtype)
    return F.linear(x, layer.weight.to(dtype))


class T5Encoder(nn.Module):
    """``T5Encoder(config)(ids)``: (B, L) token ids -> (B, L, dim) float32
    bidirectional sequence features (final-RMS-normed).

    Built on ``device`` (CUDA unless the caller asks for the CPU) with the
    projections and the token embedding in ``dtype`` (RMS gains and the
    relative bias float32), the JAX package's initialisation drawn from
    ``generator``."""

    def __init__(
        self,
        config: T5EncoderConfig = T5EncoderConfig(),
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
        dtype: torch.dtype = torch.float32,
        mesh: Any = None,
    ) -> None:
        super().__init__()
        c = config
        if mesh is not None and "tp" not in (mesh.mesh_dim_names or ()):
            raise ValueError("T5Encoder(mesh=...) needs a 'tp' mesh axis (tensor parallelism)")
        self.config = c
        self.mesh = mesh
        self.tok_embed = nn.Parameter(torch.empty(c.vocab_size, c.dim, device="meta", dtype=dtype))
        self.rel_bias = nn.Parameter(torch.empty(c.rel_buckets, c.heads, device="meta"))
        self.blocks = nn.ModuleList(_T5Block(c, dtype) for _ in range(c.depth))
        self.final_ln = nn.Parameter(torch.empty(c.dim, device="meta"))
        self._local = c  # the heads this rank runs
        if tensor_parallel.tp_size(mesh) > 1:
            tensor_parallel.cut_on_meta(tensor_parallel.linears(self), self.param_spec(), mesh)
            self._local = dataclasses.replace(c, heads=tensor_parallel.local_heads(c.heads, mesh))
        self.to_empty(device=resolve_device(device))
        self.reset_parameters(generator)

    def param_spec(self) -> dict:
        """The JAX package's megatron specs over ``tp``: q, k, v and the FF's input projections
        column-parallel, o and wo row-parallel, the rest replicated (the relative bias whole: each rank
        reads its heads' columns)."""
        P = tensor_parallel.P
        c = self.config
        ff_cols = {"wi_0": P(None, "tp"), "wi_1": P(None, "tp")} if c.gated else {"wi": P(None, "tp")}
        block = {"q": P(None, "tp"), "k": P(None, "tp"), "v": P(None, "tp"), "o": P("tp", None),
                 "ln_attn": P(), "ln_ff": P(), **ff_cols, "wo": P("tp", None)}
        return {"tok_embed": P(), "rel_bias": P(), "blocks": [dict(block) for _ in range(c.depth)], "final_ln": P()}

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The JAX package's initialisation: normal projections (``q`` over
        ``sqrt(dim * head_dim)``, the others over ``sqrt(d_in)``), unit token
        embeddings, a ``0.1 N(0, 1)`` relative bias, unit RMS gains.  Drawn on
        ``generator``'s device (the CPU, seed 0, when omitted)."""
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        c = self.config

        def normal(*shape: int) -> torch.Tensor:
            return torch.randn(shape, generator=gen, device=gen.device)

        self.tok_embed.copy_(normal(*self.tok_embed.shape))
        self.rel_bias.copy_(normal(*self.rel_bias.shape) * 0.1)
        self.final_ln.fill_(1.0)
        for block in self.blocks:
            for name, layer in block.named_children():
                d_in, d_out = tensor_parallel.whole_features(layer)
                scale = (c.dim * c.head_dim) ** -0.5 if name == "q" else d_in**-0.5
                tensor_parallel.load_dense(layer, normal(d_in, d_out) * scale)
            block.ln_attn.fill_(1.0)
            block.ln_ff.fill_(1.0)

    def param_tree(self) -> dict:
        "The parameters as the JAX package's tree of float32 numpy arrays: the inverse of :meth:`load_jax_params`."
        return _tree.param_tree(self)

    def load_jax_params(self, tree: dict) -> T5Encoder:
        """Fill the module from the JAX package's tree (``T5Encoder.init``'s or
        ``import_weights.t5_encoder``'s layout).  Every key must be consumed
        and every shape must match."""
        _tree.load_tree(self, tensor_parallel.shard_params(tree, self.param_spec(), self.mesh), "T5Encoder")
        return self

    def _rms_norm(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        out = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.config.ln_eps)
        return (out * g).to(x.dtype)

    def _position_bias(self, L: int) -> torch.Tensor:
        "(1, heads, L, L) float32 additive score bias from the bucketed embedding."
        c = self.config
        pos = np.arange(L)
        buckets = _relative_position_bucket(pos[None, :] - pos[:, None], c.rel_buckets, c.rel_max_distance)
        index = torch.from_numpy(buckets).to(self.rel_bias.device)
        heads = self._local.heads
        first = tensor_parallel.axis_rank(self.mesh) * heads  # this rank's heads under tp
        return self.rel_bias[index][..., first : first + heads].permute(2, 0, 1)[None].float()

    def forward(self, ids: Any) -> torch.Tensor:
        "(B, L) ids -> (B, L, dim) float32 sequence features."
        c = self._local
        dtype = c.compute_dtype
        ids = _ids(ids, self.tok_embed.device)
        B, L = ids.shape
        bias = self._position_bias(L)

        h = self.tok_embed[ids].to(dtype)
        for block in self.blocks:
            x = self._rms_norm(h, block.ln_attn)  # T5 leaves the scores unscaled (folded into q's init)
            q, k, v = (_mm(p, x, dtype).view(B, L, c.heads, c.head_dim).transpose(1, 2) for p in (block.q, block.k, block.v))
            scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias
            attn = torch.softmax(scores, dim=-1).to(dtype)
            out = torch.matmul(attn.float(), v.float()).transpose(1, 2).reshape(B, L, c.inner_dim)
            h = h + _mm(block.o, out.to(dtype), dtype)

            x = self._rms_norm(h, block.ln_ff)
            if c.gated:
                inner = F.gelu(_mm(block.wi_0, x, dtype), approximate="tanh") * _mm(block.wi_1, x, dtype)
            else:
                inner = F.relu(_mm(block.wi, x, dtype))
            h = h + _mm(block.wo, inner, dtype)
        return self._rms_norm(h, self.final_ln).float()

    apply = forward


def random_param_tree(config: T5EncoderConfig, seed: int) -> dict:
    """A JAX-layout T5 tree with EVERY leaf random from a numpy seed
    (projections normal over ``sqrt(d_in)``, the embedding and relative bias
    normal, RMS gains ``1 + 0.1 N(0, 1)``) for parity checks."""
    rng = np.random.default_rng(seed)
    c = config

    def mat(d_in: int, d_out: int) -> np.ndarray:
        return rng.standard_normal((d_in, d_out), dtype=np.float32) / np.float32(np.sqrt(d_in))

    def gain() -> np.ndarray:
        return np.float32(1) + rng.standard_normal(c.dim, dtype=np.float32) * np.float32(0.1)

    blocks = []
    for _ in range(c.depth):
        ff = {"wi_0": mat(c.dim, c.ff_dim), "wi_1": mat(c.dim, c.ff_dim)} if c.gated else {"wi": mat(c.dim, c.ff_dim)}
        blocks.append(
            {
                "q": mat(c.dim, c.inner_dim) / np.float32(np.sqrt(c.head_dim)),
                "k": mat(c.dim, c.inner_dim),
                "v": mat(c.dim, c.inner_dim),
                "o": mat(c.inner_dim, c.dim),
                "ln_attn": gain(),
                "ln_ff": gain(),
                **ff,
                "wo": mat(c.ff_dim, c.dim),
            }
        )
    return {
        "tok_embed": rng.standard_normal((c.vocab_size, c.dim), dtype=np.float32),
        "rel_bias": rng.standard_normal((c.rel_buckets, c.heads), dtype=np.float32),
        "blocks": blocks,
        "final_ln": gain(),
    }


def t5_encoder_forward_flops(config: T5EncoderConfig, batch: int, length: int) -> float:
    "Analytic matmul FLOPs of one forward (the JAX package's count)."
    c = config
    qkvo = 2.0 * c.dim * c.inner_dim * 4
    ff = 2.0 * c.dim * c.ff_dim * (3 if c.gated else 2)
    attn = 4.0 * length * c.inner_dim
    return batch * length * c.depth * (qkvo + ff + attn)
