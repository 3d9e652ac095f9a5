"""The CLIP-class text encoder and the byte tokenizer as PyTorch code (the
JAX package's ``models/text_encoder.py``).

A pre-LN transformer over token ids, causal (CLIP) or not, whose sequence
features are a diffusion model's ``context`` and whose EOS-position
feature through ``text_proj`` is the CLIP pooled vector.  Layer norms in
float32 (learned affine with ``ln_affine``, as CLIP checkpoints have it),
dense layers through ``_dense``, attention as plain batched products with
float32 scores and softmax: at 77-256 tokens the (L, L) scores are a few
hundred KB, and the JAX package runs them outside any kernel too.
:meth:`TextEncoder.encode` with ``layer_skip=1`` gives the penultimate
hidden states (no final LN, transformers' ``hidden_states[-2]``) beside the
full tower's pooling in one forward: the SD3 and SDXL conditioning recipe.

:meth:`TextEncoder.load_jax_params` carries the JAX package's tree across
(``import_weights.clip_text_encoder`` builds one from a transformers state
dict) and :meth:`TextEncoder.param_tree` carries it back.  On a mesh with
a ``tp`` axis each rank keeps its shard of the layers
:meth:`TextEncoder.param_spec` splits (``parallel/tensor_parallel.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops._cuda import resolve_device
from ..parallel import tensor_parallel
from . import _tree
from .dit import _dense, _int8_copy
from .flux import _linear


class ByteTokenizer:
    """UTF-8 byte tokenizer: ids 0-255 are bytes, then BOS/EOS/PAD.

    ``encode`` emits the static layout ``[BOS, bytes..., EOS, PAD...]``
    truncated to ``length`` (EOS always present: truncation drops bytes,
    never the EOS the pooled embedding anchors on)."""

    BOS = 256
    EOS = 257
    PAD = 258
    vocab_size = 259

    def encode(self, text: str, length: int) -> np.ndarray:
        data = list(text.encode("utf-8"))[: length - 2]
        ids = [self.BOS, *data, self.EOS]
        ids += [self.PAD] * (length - len(ids))
        return np.asarray(ids, np.int32)

    def decode(self, ids: Any) -> str:
        data = bytes(int(i) for i in np.asarray(ids).ravel() if int(i) < 256)
        return data.decode("utf-8", errors="replace")

    def batch(self, texts: list[str], length: int) -> np.ndarray:
        return np.stack([self.encode(t, length) for t in texts])


@dataclass(frozen=True)
class TextEncoderConfig:
    vocab_size: int = ByteTokenizer.vocab_size
    dim: int = 512
    depth: int = 6
    heads: int = 8
    mlp_ratio: int = 4
    max_tokens: int = 128
    "Static sequence length (the position table's rows)."
    causal: bool = True
    compute_dtype: torch.dtype = torch.bfloat16
    ln_affine: bool = False
    "Learnable LayerNorm gain/bias (CLIP checkpoints have them)."
    ln_eps: float = 1e-6
    act: str = "gelu_tanh"
    '``"gelu_tanh"`` (default), ``"gelu"`` (exact erf), or ``"quick_gelu"``.'
    eos_id: int | None = None
    "EOS token id for pooling; ``None`` uses :attr:`ByteTokenizer.EOS`."
    proj_dim: int = 0
    """Width of the pooled ``text_proj`` output; 0 is ``dim``.  The JAX
    package reads it off its tree's ``text_proj`` weight; a module here is
    built before its tree arrives (``clip_text_config`` sets it from the
    checkpoint's ``projection_dim``)."""

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def resolved_eos_id(self) -> int:
        return ByteTokenizer.EOS if self.eos_id is None else self.eos_id


_ACTIVATIONS = {
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "gelu": F.gelu,
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
}


class _LayerNorm(nn.Module):
    "A LayerNorm's learned gain and bias, float32 (the JAX tree's ``{g, b}``)."

    def __init__(self, d: int) -> None:
        super().__init__()
        self.g = nn.Parameter(torch.empty(d, device="meta"))
        self.b = nn.Parameter(torch.empty(d, device="meta"))


def _layer_norm(x: torch.Tensor, p: _LayerNorm | None, eps: float) -> torch.Tensor:
    "The JAX package's ``_ln``: statistics in float32, the optional affine, one rounding to ``x``'s dtype."
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    if p is not None:
        out = out * p.g + p.b
    return out.to(x.dtype)


class _Block(nn.Module):
    def __init__(self, c: TextEncoderConfig, dtype: torch.dtype) -> None:
        super().__init__()
        self.qkv = _linear(c.dim, 3 * c.dim, dtype)
        self.proj = _linear(c.dim, c.dim, dtype)
        self.mlp_in = _linear(c.dim, c.mlp_ratio * c.dim, dtype)
        self.mlp_out = _linear(c.mlp_ratio * c.dim, c.dim, dtype)
        if c.ln_affine:
            self.ln1 = _LayerNorm(c.dim)
            self.ln2 = _LayerNorm(c.dim)


def _ids(ids: Any, device: torch.device) -> torch.Tensor:
    "Token ids (numpy, a list or a tensor) as an int64 tensor on ``device``."
    return torch.as_tensor(np.asarray(ids) if not isinstance(ids, torch.Tensor) else ids, device=device).long()


class TextEncoder(nn.Module):
    """``TextEncoder(config)(ids, layer_skip=0)``: (B, L) token ids -> (B, L,
    dim) float32 sequence features (final-LN'd; ``layer_skip=k``: the raw
    hidden state k blocks early); :meth:`encode` -> ``(features, pooled)``.

    Built on ``device`` (CUDA unless the caller asks for the CPU) with dense
    layers and embeddings in ``dtype`` (layer-norm affines float32), the JAX
    package's initialisation drawn from ``generator``."""

    def __init__(
        self,
        config: TextEncoderConfig = TextEncoderConfig(),
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
        dtype: torch.dtype = torch.float32,
        mesh: Any = None,
    ) -> None:
        super().__init__()
        c = config
        if c.dim % c.heads:
            raise ValueError("dim must divide by heads")
        if mesh is not None and "tp" not in (mesh.mesh_dim_names or ()):
            raise ValueError("TextEncoder(mesh=...) needs a 'tp' mesh axis (tensor parallelism)")
        self.mesh = mesh
        if c.act not in _ACTIVATIONS:
            raise ValueError(f"unknown act {c.act!r}")
        self.config = c
        self.tok_embed = nn.Parameter(torch.empty(c.vocab_size, c.dim, device="meta", dtype=dtype))
        self.pos_embed = nn.Parameter(torch.empty(c.max_tokens, c.dim, device="meta", dtype=dtype))
        self.blocks = nn.ModuleList(_Block(c, dtype) for _ in range(c.depth))
        self.text_proj = _linear(c.dim, c.proj_dim or c.dim, dtype)
        if c.ln_affine:
            self.final_ln = _LayerNorm(c.dim)
        self._local = c  # the heads this rank's attention runs
        if tensor_parallel.tp_size(mesh) > 1:
            tensor_parallel.cut_on_meta(tensor_parallel.linears(self), self.param_spec(), mesh, self._tp_segments())
            self._local = tensor_parallel.local_config(c, mesh)
        self.to_empty(device=resolve_device(device))
        self.reset_parameters(generator)

    def _tp_segments(self) -> dict[str, tuple[int, ...]]:
        "The fused qkv's three parts, each split over ``tp`` by heads."
        d = self.config.dim
        return {f"blocks.{i}.qkv": (d, d, d) for i in range(self.config.depth)}

    def param_spec(self, quantized: bool = False) -> dict:
        """The JAX package's tensor-parallel specs over ``tp``: qkv and mlp_in column-parallel, proj
        and mlp_out row-parallel, the embeddings, layer norms and ``text_proj`` replicated; int8's with
        ``quantized``."""
        col, row, rep = tensor_parallel.dense_specs(quantized)
        P = tensor_parallel.P
        ln = {"g": P(), "b": P()}
        affine = self.config.ln_affine
        spec: dict = {
            "tok_embed": P(),
            "pos_embed": P(),
            "blocks": [
                {"qkv": dict(col), "proj": dict(row), "mlp_in": dict(col), "mlp_out": dict(row),
                 **({"ln1": dict(ln), "ln2": dict(ln)} if affine else {})}
                for _ in range(self.config.depth)
            ],
            "text_proj": rep,
        }
        if affine:
            spec["final_ln"] = dict(ln)
        return spec

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The JAX package's initialisation: token embeddings ``0.02 N(0, 1)``,
        positions ``0.01 N(0, 1)``, dense weights normal over ``sqrt(d_in)``
        (``proj``/``mlp_out`` at ``0.02 / sqrt(2 depth)``), zero biases, unit
        layer-norm gains.  Drawn on ``generator``'s device (the CPU, seed 0,
        when omitted)."""
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        c = self.config

        def normal(*shape: int) -> torch.Tensor:
            return torch.randn(shape, generator=gen, device=gen.device)

        self.tok_embed.copy_(normal(*self.tok_embed.shape) * 0.02)
        self.pos_embed.copy_(normal(*self.pos_embed.shape) * 0.01)
        for name, module in self.named_modules():
            if isinstance(module, nn.Linear):
                d_in, d_out = tensor_parallel.whole_features(module)
                small = name.rpartition(".")[2] in ("proj", "mlp_out")
                scale = 0.02 / math.sqrt(2 * c.depth) if small else 1 / math.sqrt(d_in)
                tensor_parallel.load_dense(module, normal(d_in, d_out) * scale, torch.zeros(d_out))
            elif isinstance(module, _LayerNorm):
                module.g.fill_(1.0)
                module.b.zero_()

    def param_tree(self) -> dict:
        "The parameters as the JAX package's tree of float32 numpy arrays: the inverse of :meth:`load_jax_params`."
        return _tree.param_tree(self)

    def load_jax_params(self, tree: dict) -> TextEncoder:
        """Fill the module from the JAX package's tree (``TextEncoder.init``'s
        or ``import_weights.clip_text_encoder``'s layout).  Every key must be
        consumed and every shape must match."""
        tree = tensor_parallel.shard_params(tree, self.param_spec(), self.mesh, self._tp_segments())
        _tree.load_tree(self, tree, "TextEncoder")
        return self

    def quantize_params(self) -> TextEncoder:
        """The int8 serving tower, the JAX package's recipe: every block's
        dense layers as int8 (kernel B6 in front of each product); the
        embeddings and ``text_proj`` stay, shared with this model."""
        return _int8_copy(self, frozenset({"tok_embed", "pos_embed", "text_proj"}))

    def _attention(self, qkv: torch.Tensor) -> torch.Tensor:
        "Plain attention: float32 scores and softmax (causal mask), probabilities in qkv's dtype."
        c = self._local
        B, L, _ = qkv.shape
        q, k, v = (part.reshape(B, L, c.heads, c.head_dim).transpose(1, 2).float() for part in qkv.chunk(3, dim=-1))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(c.head_dim)
        if c.causal:
            mask = torch.ones((L, L), dtype=torch.bool, device=qkv.device).tril()
            scores = scores.masked_fill(~mask, float("-inf"))
        attn = torch.softmax(scores, dim=-1).to(qkv.dtype)
        out = torch.matmul(attn.float(), v)
        return out.transpose(1, 2).reshape(B, L, c.dim).to(qkv.dtype)

    def _tower(self, ids: Any, capture_skip: int = 0) -> tuple[torch.Tensor, torch.Tensor | None]:
        """One pass through the blocks: the final-LN'd states (float32) and,
        with ``capture_skip > 0``, the raw hidden state ``capture_skip``
        blocks early (transformers' ``hidden_states[-(capture_skip + 1)]``)."""
        c = self.config
        dtype = c.compute_dtype
        ids = _ids(ids, self.tok_embed.device)
        L = ids.shape[-1]
        if L > c.max_tokens:
            raise ValueError(f"sequence length {L} > max_tokens {c.max_tokens}")
        act = _ACTIVATIONS[c.act]
        h = (self.tok_embed[ids].float() + self.pos_embed[:L].float()).to(dtype)
        captured = None
        for i, block in enumerate(self.blocks):
            if capture_skip and i == len(self.blocks) - capture_skip:
                captured = h
            norm = _layer_norm(h, getattr(block, "ln1", None), c.ln_eps)
            h = h + _dense(block.proj, self._attention(_dense(block.qkv, norm, dtype)), dtype)
            norm = _layer_norm(h, getattr(block, "ln2", None), c.ln_eps)
            h = h + _dense(block.mlp_out, act(_dense(block.mlp_in, norm, dtype)), dtype)
        final = _layer_norm(h, getattr(self, "final_ln", None), c.ln_eps).float()
        return final, None if captured is None else captured.float()

    def forward(self, ids: Any, layer_skip: int = 0) -> torch.Tensor:
        """(B, L) ids -> (B, L, dim) sequence features (final-LN'd, float32);
        ``layer_skip=k`` stops k blocks early and returns the raw hidden state
        (the "clip skip" convention: SD3 and SDXL condition on ``k = 1``)."""
        final, captured = self._tower(ids, capture_skip=layer_skip)
        return captured if layer_skip else final

    apply = forward

    def encode(self, ids: Any, layer_skip: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
        """ids -> ``(features, pooled)``: the sequence features (as
        :meth:`forward` with ``layer_skip``) and the (B, dim) float32
        ``text_proj`` of the full tower's feature at each row's first EOS
        (the CLIP pooling), in one forward."""
        c = self.config
        final, captured = self._tower(ids, capture_skip=layer_skip)
        ids = _ids(ids, final.device)
        eos = (ids == c.resolved_eos_id).int().argmax(dim=-1)
        at_eos = final[torch.arange(final.shape[0], device=final.device), eos]
        pooled = _dense(self.text_proj, at_eos.to(c.compute_dtype), c.compute_dtype)
        return (captured if layer_skip else final), pooled.float()


def random_param_tree(config: TextEncoderConfig, seed: int) -> dict:
    """A JAX-layout tree with EVERY leaf random from a numpy seed (dense
    weights normal over ``sqrt(d_in)``, biases ``0.1 N(0, 1)``, embeddings
    ``0.02 N(0, 1)``, layer-norm gains ``1 + 0.1 N(0, 1)`` and biases ``0.1
    N(0, 1)``) for parity checks."""
    rng = np.random.default_rng(seed)
    c = config

    def normal(*shape: int, scale: float = 1.0) -> np.ndarray:
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    def dense(d_in: int, d_out: int) -> dict:
        return {"w": normal(d_in, d_out, scale=1 / math.sqrt(d_in)), "b": normal(d_out, scale=0.1)}

    def ln() -> dict:
        return {"g": np.float32(1) + normal(c.dim, scale=0.1), "b": normal(c.dim, scale=0.1)}

    tree: dict = {
        "tok_embed": normal(c.vocab_size, c.dim, scale=0.02),
        "pos_embed": normal(c.max_tokens, c.dim, scale=0.02),
        "blocks": [
            {
                "qkv": dense(c.dim, 3 * c.dim),
                "proj": dense(c.dim, c.dim),
                "mlp_in": dense(c.dim, c.mlp_ratio * c.dim),
                "mlp_out": dense(c.mlp_ratio * c.dim, c.dim),
                **({"ln1": ln(), "ln2": ln()} if c.ln_affine else {}),
            }
            for _ in range(c.depth)
        ],
        "text_proj": dense(c.dim, c.proj_dim or c.dim),
    }
    if c.ln_affine:
        tree["final_ln"] = ln()
    return tree


def text_encoder_forward_flops(config: TextEncoderConfig, batch: int, length: int) -> float:
    "Analytic matmul FLOPs of one forward (the JAX package's count)."
    c = config
    d = c.dim
    per_token = c.depth * d * d * (6 + 2 + 4 * c.mlp_ratio)
    attn = 4.0 * c.depth * length * length * d
    return batch * (length * per_token + attn + 2.0 * d * d)
