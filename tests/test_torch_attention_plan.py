"""The Hopper attention's plans and tilings (K2, K4, B9, B10, B11; K5's two kernels), held on the CPU.

``attention_plan`` is plain Python: its invariants are checked across (N, d).  The kernel itself
runs only on the card (``tests/test_torch_kernels.py``), so its arithmetic is emulated here in
float32 PyTorch, tile by tile as ``csrc/flash_attention_sm90.cu`` does it: query rows in blocks of
the plan's ``block_q`` (rows past N zero-filled, as TMA fills them, and dropped), keys in tiles of
``block_k`` (keys past N zero-filled and masked to -inf before the row max), the online softmax in
log2 units with the max taken on the raw scores, P rounded to the 16-bit type before the value
product, one normalisation and one rounding at the end.  The emulation is held against the port's
plain attention and the JAX package's einsum reference at ragged N, and against the JAX package's
Pallas kernels (interpret mode, as its own tests run them) at a tiled N.  B11's arguments carry its
query and key counts apart, and its tiling is emulated at ragged Nq != Nk against the plain version and
the JAX package's ``flash_attention_block_stats``.  K5's ``attention_backward_plan`` is checked the same
way, and its two kernels' tiling (dq over query blocks against key tiles, dk and dv over key blocks
against query tiles, P and dS rounded to 16 bits before their products) is emulated against the plain
backward at ragged N and the JAX package's Pallas backward in interpret mode.
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


# ---- B11 on the Hopper body: separate query and key counts ------------------------------------------


def _emulate_block_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, plan):
    """B11 on the Hopper body: the emulated tiling over ``Nq`` query rows (blocks of ``block_q``) and a K/V
    block of ``Nk`` keys (tiles of ``block_k``, masked at Nk) -> ``(o, m, l)``, m in natural-log units."""
    B, H, Nq, d = q.shape
    Nk = k.shape[2]
    bq, bk = plan.block_q, plan.block_k
    nq, nk = -(-Nq // bq) * bq, -(-Nk // bk) * bk
    scale = _LOG2E / math.sqrt(d)

    def filled(x: torch.Tensor, rows: int) -> torch.Tensor:  # TMA's zero fill past the map's rows
        out = torch.zeros((B, H, rows, d))
        out[:, :, : x.shape[2]] = x.float()
        return out

    qf, kf, vf = filled(q, nq), filled(k, nk), filled(v, nk)
    m = torch.full((B, H, nq), -math.inf)
    l = torch.zeros((B, H, nq))
    o = torch.zeros((B, H, nq, d))
    for j in range(nk // bk):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, j * bk : (j + 1) * bk])
        s[..., torch.arange(j * bk, (j + 1) * bk) >= Nk] = -math.inf
        m_new = torch.maximum(m, s.amax(-1) * scale)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale - m_new[..., None])
        l = l * alpha + p.sum(-1)
        vt = vf[:, :, j * bk : (j + 1) * bk]
        o = o * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(), vt)
        m = m_new
    return (o / l[..., None]).to(q.dtype)[:, :, :Nq], (m * math.log(2))[:, :, :Nq], l[:, :, :Nq]


@pytest.mark.parametrize(("Nq", "Nk", "d"), [(40, 24, 64), (100, 300, 128), (1152, 1152, 128), (256, 96, 64)])
def test_block_stats_args_take_separate_counts(Nq: int, Nk: int, d: int) -> None:
    """B11's arguments (built here on CPU tensors: the pointers are never read) carry Nq and Nk apart,
    every operand's (batch, head, row) strides, the true head dim's scale and ``attention_plan`` at Nq."""
    q = torch.zeros((2, Nq, 3 * 3 * d), dtype=torch.bfloat16)[..., : 3 * d].reshape(2, Nq, 3, d).transpose(1, 2)
    kv = torch.zeros((2, Nk, 2 * 3 * d), dtype=torch.bfloat16)
    k, v = (t.reshape(2, Nk, 3, d).transpose(1, 2) for t in kv.chunk(2, dim=-1))
    o = torch.empty((2, 3, Nq, d), dtype=torch.bfloat16)
    m, l = torch.empty((2, 3, Nq)), torch.empty((2, 3, Nq))
    args = tfa._block_stats_args(q, k, v, o, m, l, d)
    plan = tfa.attention_plan(Nq, d)
    assert (args.B, args.H, args.Nq, args.Nk, args.d) == (2, 3, Nq, Nk, d)
    assert (args.block_q, args.stages) == (plan.block_q, plan.stages)
    assert list(args.q_strides) == [Nq * 9 * d, d, 9 * d] and list(args.k_strides) == [Nk * 6 * d, d, 6 * d]
    assert list(args.o_strides) == [3 * Nq * d, Nq * d, d]
    assert args.k == k.data_ptr() and args.v == v.data_ptr() and args.v - args.k == 3 * d * 2
    assert args.scale_log2 == pytest.approx(_LOG2E / math.sqrt(d))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize(("Nq", "Nk"), [(40, 24), (100, 300), (1152, 1152)])
def test_block_stats_emulation_matches_plain(Nq: int, Nk: int, d: int) -> None:
    """The emulated B11 tiling at separate, ragged counts against the port's plain ``_block_stats_reference``
    and the JAX package's ``flash_attention_block_stats`` (its einsum branch at these counts) on the same
    bf16 inputs: o within 5e-3 plus one bf16 ulp of the plain value (the card test's bound), m and l
    within 1e-3 of their largest value."""
    rng = np.random.default_rng(Nq + Nk + d)
    H = 1 if Nq > 1024 else 2
    arrays = (rng.standard_normal((1, H, n, d), dtype=np.float32) for n in (Nq, Nk, Nk))
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    o, m, l = _emulate_block_stats(q, k, v, tfa.attention_plan(Nq, d))
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v))
    jo, jm, jl = jfa.flash_attention_block_stats(jq, jk, jv, interpret=True)
    jax_out = tuple(torch.from_numpy(np.array(t.astype(jnp.float32))) for t in (jo, jm, jl))
    for ro, rm, rl in (tfa._block_stats_reference(q, k, v), jax_out):
        assert ((o.float() - ro.float()).abs() <= 5e-3 + 2**-8 * ro.float().abs()).all()
        for got, want in ((m, rm), (l, rl)):
            assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item()


# ---- K5 on Hopper: the backward's plan and its two kernels' tiling --------------------------------------


@pytest.mark.parametrize("N", [1, 64, 100, 1000, 1024, 4608])
def test_backward_plan_invariants(N: int) -> None:
    """K5's plan fits a block's 227 KB in both kernels, each shared memory is the source's sum (resident
    tiles, the ring, the dkv kernel's lse and delta rows, the mbarriers, the alignment slack), the blocks
    cover N exactly, the dq kernel's key tile is 128, the dkv kernel's query tile 64, each ring has two
    stages or more, and it reads nothing but (N, d).  At the DiT's training shape (4, 1024, 4 heads of 128)
    each kernel's grid is 8 x 4 x 4 = 128 blocks, one wave on 132 SMs; at N = 1000 the same."""
    d = 128
    plan = tfa.attention_backward_plan(N, d)
    tile = lambda rows: rows * d * 2  # noqa: E731
    assert (plan.block, plan.key_tile, plan.query_tile) == (128, 128, 64)
    assert plan.dq_stages >= 2 and plan.dkv_stages >= 2
    assert plan.dq_smem == 2 * tile(128) + 2 * plan.dq_stages * tile(128) + (1 + 2 * plan.dq_stages) * 8 + 1024
    rows = plan.dkv_stages * 2 * 64 * 4  # each stage's lse and delta
    assert plan.dkv_smem == 2 * tile(128) + 2 * plan.dkv_stages * tile(64) + rows + (1 + 2 * plan.dkv_stages) * 8 + 1024
    assert max(plan.dq_smem, plan.dkv_smem) <= _SMEM_LIMIT
    assert plan.blocks * plan.block >= N > (plan.blocks - 1) * plan.block
    if N in (1000, 1024):
        assert plan.blocks * 4 * 4 == 128
    assert list(inspect.signature(tfa.attention_backward_plan).parameters) == ["N", "d"]


@pytest.mark.parametrize("d", [64, 96])
def test_backward_plan_refuses_a_head_dim_without_an_instance(d: int) -> None:
    with pytest.raises(ValueError, match="head dim"):
        tfa.attention_backward_plan(1024, d)


def _emulate_backward(qkv: torch.Tensor, o: torch.Tensor, lse: torch.Tensor, g: torch.Tensor, heads: int, plan):
    """K5's two kernels' arithmetic on 16-bit inputs, tile by tile as ``csrc/flash_attention_bwd.cu`` does it:
    dq over query blocks of ``plan.block`` against key tiles of ``key_tile`` (keys past N masked before the
    exponentials), dk and dv over key blocks of ``plan.block`` against query tiles of ``query_tile`` (a
    query past N reads lse = +inf and delta 0); rows past N zero-filled, as TMA fills them, and dropped;
    P and dS rounded to the 16-bit type before the products they feed, each output rounded once."""
    dtype = qkv.dtype
    B, N, D3 = qkv.shape
    d = D3 // 3 // heads
    q, k, v = (tfa._heads(part, heads) for part in qkv.chunk(3, dim=-1))
    do = tfa._heads(g, heads)
    delta = (do * tfa._heads(o, heads)).sum(-1)
    lse2 = lse[..., 0] * _LOG2E
    scale = 1.0 / math.sqrt(d)
    bb, kt, qt = plan.block, plan.key_tile, plan.query_tile

    def filled(x: torch.Tensor, rows: int, fill: float = 0.0) -> torch.Tensor:
        out = torch.full((*x.shape[:2], rows, *x.shape[3:]), fill)
        out[:, :, :N] = x
        return out

    nb, nk, nq = plan.blocks * bb, -(-N // kt) * kt, -(-N // qt) * qt
    # the dq kernel
    qb, dob, lb, db = filled(q, nb), filled(do, nb), filled(lse2, nb, math.inf), filled(delta, nb)
    kf, vf = filled(k, nk), filled(v, nk)
    dq = torch.zeros((B, heads, nb, d))
    for j in range(nk // kt):
        kj, vj = kf[:, :, j * kt : (j + 1) * kt], vf[:, :, j * kt : (j + 1) * kt]
        s = qb @ kj.transpose(-1, -2)
        s[..., torch.arange(j * kt, (j + 1) * kt) >= N] = -math.inf
        p = torch.exp2(s * scale * _LOG2E - lb[..., None])
        ds = (p * (dob @ vj.transpose(-1, -2) - db[..., None])).to(dtype).float()
        dq = dq + ds @ kj
    # the dkv kernel
    kb, vb = filled(k, nb), filled(v, nb)
    qf, dof, lf, df = filled(q, nq), filled(do, nq), filled(lse2, nq, math.inf), filled(delta, nq)
    dk, dv = torch.zeros((B, heads, nb, d)), torch.zeros((B, heads, nb, d))
    for i in range(nq // qt):
        qi, doi = qf[:, :, i * qt : (i + 1) * qt], dof[:, :, i * qt : (i + 1) * qt]
        pt = torch.exp2(kb @ qi.transpose(-1, -2) * scale * _LOG2E - lf[:, :, None, i * qt : (i + 1) * qt])
        dv = dv + pt.to(dtype).float() @ doi
        dst = (pt * (vb @ doi.transpose(-1, -2) - df[:, :, None, i * qt : (i + 1) * qt])).to(dtype).float()
        dk = dk + dst @ qi
    thirds = ((dq * scale)[:, :, :N], (dk * scale)[:, :, :N], dv[:, :, :N])
    return torch.cat([tfa._merge(t.to(dtype)) for t in thirds], dim=-1)


def _backward_inputs(rng: np.random.Generator, B: int, N: int, H: int) -> tuple[torch.Tensor, ...]:
    "bf16 qkv and g from numpy, and o and lse from the plain K4: K5's inputs."
    qkv = torch.from_numpy(rng.standard_normal((B, N, 3 * H * 128), dtype=np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((B, N, H * 128), dtype=np.float32)).to(torch.bfloat16)
    o, lse = tfa._qkv_reference_lse(qkv, H)
    return qkv, o, lse, g


def _third_errors(got: torch.Tensor, want: torch.Tensor) -> list[float]:
    "Each third's (dq, dk, dv) largest error over its largest value."
    return [
        (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
        for a, b in zip(got.chunk(3, dim=-1), want.chunk(3, dim=-1))
    ]


@pytest.mark.parametrize("N", [64, 100, 1000])
def test_backward_emulation_matches_plain_at_any_n(N: int) -> None:
    """The emulated K5 tiling at tiled and ragged N against the port's plain backward on the same bf16
    inputs: each third within 1e-2 of its largest value (the card test's 2e-2 with room: both round P and
    dS once, from f32 sums in another order)."""
    rng = np.random.default_rng(N)
    qkv, o, lse, g = _backward_inputs(rng, 1, N, 2)
    got = _emulate_backward(qkv, o, lse, g, 2, tfa.attention_backward_plan(N, 128))
    assert got.shape == qkv.shape and torch.isfinite(got).all()
    assert max(_third_errors(got, tfa._qkv_backward_reference(qkv, o, lse, g, 2))) <= 1e-2


def test_backward_emulation_matches_the_jax_kernels() -> None:
    """At a tiled N (256) the emulated K5 tiling against the JAX package's Pallas backward in interpret mode
    (128-row query and key blocks) on the same bf16 inputs and the same lse: each third within 1e-2 of its
    largest value."""
    rng = np.random.default_rng(11)
    B, N, H = 2, 256, 2
    qkv, o, lse, g = _backward_inputs(rng, B, N, H)
    got = _emulate_backward(qkv, o, lse, g, H, tfa.attention_backward_plan(N, 128))
    j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)  # noqa: E731
    want = jfa.flash_attention_qkv_backward(
        j(qkv), j(o), jnp.asarray(lse.numpy()), j(g), H, block_q=128, block_k=128, interpret=True
    )
    assert max(_third_errors(got, torch.from_numpy(np.array(want.astype(jnp.float32))))) <= 1e-2
