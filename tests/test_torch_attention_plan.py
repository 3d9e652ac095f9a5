"""The Hopper forward attention's plan and tiling (K2, K4, B9, B10), held on the CPU.

``attention_plan`` is plain Python: its invariants are checked across (N, d).  The kernel itself
runs only on the card (``tests/test_torch_kernels.py``), so its arithmetic is emulated here in
float32 PyTorch, tile by tile as ``csrc/flash_attention_sm90.cu`` does it: query rows in blocks of
the plan's ``block_q`` (rows past N zero-filled, as TMA fills them, and dropped), keys in tiles of
``block_k`` (keys past N zero-filled and masked to -inf before the row max), the online softmax in
log2 units with the max taken on the raw scores, P rounded to the 16-bit type before the value
product, one normalisation and one rounding at the end.  The emulation is held against the port's
plain attention and the JAX package's einsum reference at ragged N, and against the JAX package's
Pallas kernels (interpret mode, as its own tests run them) at a tiled N.
"""

from __future__ import annotations

import importlib
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skrample_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("skrample_tpu.ops.flash_attention")  # skrample_tpu.ops re-exports a function of that name

_LOG2E = 1.4426950408889634
_SMEM_LIMIT = 232448  # bytes of shared memory a block may use on the H100


def _emulate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, plan, mask: bool = True):
    """The Hopper body's arithmetic on (B, H, N, d) 16-bit q, k, v: ``(out, lse)``, out in q's dtype and
    lse (B, H, N) float32 in natural-log units.  ``mask=False`` leaves the zero-filled keys of a ragged
    last tile unmasked (they score 0), to show that the mask is needed."""
    B, H, N, d = q.shape
    bq, bk = plan.block_q, plan.block_k
    nq, nk = -(-N // bq) * bq, -(-N // bk) * bk
    scale = _LOG2E / math.sqrt(d)

    def filled(x: torch.Tensor, rows: int) -> torch.Tensor:  # TMA's zero fill past N
        out = torch.zeros((B, H, rows, d))
        out[:, :, :N] = x.float()
        return out

    qt = filled(q, nq).view(B, H, nq // bq, bq, d)  # the query blocks
    kf, vf = filled(k, nk), filled(v, nk)
    m = torch.full((B, H, nq // bq, bq), -math.inf)
    l = torch.zeros((B, H, nq // bq, bq))
    o = torch.zeros((B, H, nq // bq, bq, d))
    for j in range(nk // bk):
        kt, vt = kf[:, :, j * bk : (j + 1) * bk], vf[:, :, j * bk : (j + 1) * bk]
        s = torch.einsum("bhtqd,bhkd->bhtqk", qt, kt)
        if mask:
            s[..., torch.arange(j * bk, (j + 1) * bk) >= N] = -math.inf
        m_new = torch.maximum(m, s.amax(-1) * scale)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum("bhtqk,bhkd->bhtqd", p.to(q.dtype).float(), vt)
        m = m_new
    out = (o / l[..., None]).to(q.dtype).view(B, H, nq, d)[:, :, :N]
    lse = (m * math.log(2) + torch.log(l)).view(B, H, nq)[:, :, :N]
    return out, lse


def _heads(rng: np.random.Generator, B: int, H: int, N: int, d: int) -> tuple[np.ndarray, ...]:
    return tuple(rng.standard_normal((B, H, N, d), dtype=np.float32) for _ in range(3))


def _within(got: torch.Tensor, want: torch.Tensor) -> float:
    """How far ``got`` is past the card tests' bound (<= 0 inside it): atol 5e-3, or one bf16 ulp of the
    largest output where that is more (P rounds before its normalisation in the kernel, after it in the
    plain version)."""
    top = want.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    return (got.float() - want.float()).abs().max().item() - max(5e-3, ulp)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("N", [1, 77, 128, 1000, 1024, 4592, 4608, 32768])
def test_attention_plan_invariants(N: int, d: int) -> None:
    """The plan fits the block's 227 KB, its shared memory is the kernel's sum (Q tile, the K/V ring,
    the mbarriers, the alignment slack), its blocks cover N exactly, the ring has two stages or more,
    the key tile is 128 (the order of every row's sums), and it reads nothing but (N, d)."""
    plan = tfa.attention_plan(N, d)
    assert plan.smem <= _SMEM_LIMIT
    assert plan.smem == (plan.block_q + 2 * plan.stages * plan.block_k) * d * 2 + (1 + 4 * plan.stages) * 8 + 1024
    assert plan.block_q % 64 == 0 and plan.block_k == 128 and plan.stages >= 2
    blocks = -(-N // plan.block_q)  # the grid's query blocks a (batch item, head), as the kernel launches it
    assert blocks * plan.block_q >= N > (blocks - 1) * plan.block_q
    assert list(inspect.signature(tfa.attention_plan).parameters) == ["N", "d"]


@pytest.mark.parametrize("d", [32, 96, 256])
def test_attention_plan_refuses_a_head_dim_without_an_instance(d: int) -> None:
    with pytest.raises(ValueError, match="head dim"):
        tfa.attention_plan(1024, d)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("N", [77, 1000, 4592])
def test_tiling_emulation_matches_plain_at_ragged_n(N: int, d: int) -> None:
    """The emulated tiling at ragged N against the port's plain attention and the JAX package's einsum
    reference on the same bf16 inputs, within the card tests' bound (``_within``); its lse against the
    plain logsumexp within 1e-3 (K4's tolerance)."""
    rng = np.random.default_rng(N + d)
    H = 1 if N > 4096 else 2
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _heads(rng, 1, H, N, d))
    got, lse = _emulate(q, k, v, tfa.attention_plan(N, d))
    assert got.shape == q.shape and torch.isfinite(got).all()
    assert _within(got, tfa.attention_reference(q, k, v)) <= 0
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v))
    want = torch.from_numpy(np.array(jfa.attention_reference(jq, jk, jv).astype(jnp.float32)))
    assert _within(got, want) <= 0
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    assert (lse - torch.logsumexp(s, -1)).abs().max().item() <= 1e-3


def test_tiling_emulation_needs_the_key_mask() -> None:
    """Without the mask the zero-filled keys of N = 77's one ragged tile score 0 and take probability:
    the output moves far past the bound; with it, it stays inside."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _heads(rng, 1, 2, 77, 64))
    want = tfa.attention_reference(q, k, v)
    plan = tfa.attention_plan(77, 64)
    assert _within(_emulate(q, k, v, plan)[0], want) <= 0
    assert _within(_emulate(q, k, v, plan, mask=False)[0], want) > 0.05


@pytest.mark.parametrize("d", [64, 128])
def test_tiling_emulation_matches_the_jax_kernels(d: int) -> None:
    """At a tiled N (256: two key tiles of 128) the emulation against the JAX package's Pallas kernels in
    interpret mode with 128-row query and key blocks, the same online recurrence: d = 128 through
    ``flash_attention_qkv_forward`` and ``flash_attention_qkv_forward_lse`` on a packed qkv tensor (K2,
    K4), d = 64 through ``flash_attention_forward`` on (B, H, N, d) (B9a).  bf16 outputs within 1e-3
    plus one ulp of each value (the max is taken before or after the scale), lse within 1e-4."""
    rng = np.random.default_rng(d)
    B, H, N = 2, 2, 256
    plan = tfa.attention_plan(N, d)
    if d == 128:
        qkv = rng.standard_normal((B, N, 3 * H * d), dtype=np.float32)
        t = torch.from_numpy(qkv).to(torch.bfloat16)
        q, k, v = (part.reshape(B, N, H, d).transpose(1, 2) for part in t.chunk(3, dim=-1))
        jqkv = jnp.asarray(qkv, jnp.bfloat16)
        want = jfa.flash_attention_qkv_forward(jqkv, H, block_q=128, block_k=128, interpret=True)
        want = torch.from_numpy(np.array(want.astype(jnp.float32))).reshape(B, N, H, d).transpose(1, 2)
        _, want_lse = jfa.flash_attention_qkv_forward_lse(jqkv, H, block_q=128, block_k=128, interpret=True)
        want_lse = torch.from_numpy(np.array(want_lse))[..., 0]
    else:
        arrays = _heads(rng, B, H, N, d)
        q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
        want = jfa.flash_attention_forward(jq, jk, jv, block_q=128, block_k=128, interpret=True)
        want = torch.from_numpy(np.array(want.astype(jnp.float32)))
        want_lse = None
    got, lse = _emulate(q, k, v, plan)
    assert torch.all((got.float() - want).abs() <= 1e-3 + 2**-8 * want.abs())
    if want_lse is not None:
        assert (lse - want_lse).abs().max().item() <= 1e-4
