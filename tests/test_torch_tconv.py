"""B13's plain version (``ops/fused_conv.py``: the causal temporal conv with GroupNorm+SiLU on its
input read) against the JAX package's ``tconv_causal_gn_silu`` (its Pallas kernel in interpret mode),
on the CPU.

All three forms the video VAE's fused decode uses, in float32: with the norm and the statistics
chain (a temporal resblock's first conv), with the norm and a residual (its second), and the
un-normed frame-repeat upsample (``repeat_in=2``): rtol/atol 1e-5, the same float32 arithmetic
summed in another order.  The autograd Function's gradients against ``jax.vjp`` (rtol 1e-4).  B13's
wgmma plan (``tconv_plan``): its invariants at the decode's shapes, and a float64 emulation of its
frame walk (the ring of normalized frames, slots reused only after their last reader) against the
plain version.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skrample_tpu_torch.ops import fused_conv as tfc

jfc = importlib.import_module("skrample_tpu.ops.fused_conv")

B, T, S, C, CO, K = 2, 4, 64, 16, 24, 3  # S a multiple of 64: the JAX dispatch takes its kernel


def _inputs(seed: int, mode: str):
    rng = np.random.default_rng(seed)
    co = C if mode == "residual" else CO
    x = (rng.standard_normal((B, T, S, C), dtype=np.float32) * 1.5 + 0.3).astype(np.float32)
    w = (rng.standard_normal((K, C, co), dtype=np.float32) / np.sqrt(K * C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(co)).astype(np.float32)
    stats = residual = None
    if mode != "repeat":
        raw = np.asarray(jfc.channel_stats(jnp.asarray(x), sample_dims=2))
        stats = np.asarray(jfc.finalize_group_stats(jnp.asarray(raw), 4, S))
    if mode == "residual":
        residual = rng.standard_normal((B, T, S, co), dtype=np.float32)
    return x, w, b, stats, residual, 2 if mode == "repeat" else 1


def _torch(a):
    return None if a is None else torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("mode", ["stats", "residual", "repeat"])
def test_plain_b13_matches_the_pallas_kernel(mode: str) -> None:
    "Output and its per-(item, frame) statistics: rtol/atol 1e-5 against the interpret-mode kernel."
    x, w, b, stats, residual, rep = _inputs(1, mode)
    jargs = [None if a is None else jnp.asarray(a) for a in (x, w, b, stats, residual)]
    want, want_raw = jfc.tconv_causal_gn_silu(*jargs, repeat_in=rep, interpret=True)
    got, raw = tfc.tconv_causal_gn_silu_forward(*(_torch(a) for a in (x, w, b, stats, residual)), repeat_in=rep)
    assert got.shape == (B, T * rep, S, w.shape[-1]) and raw.shape == (B, T * rep, 2, w.shape[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(raw.numpy(), np.asarray(want_raw), rtol=1e-5, atol=1e-4)
    ref, ref_raw = jfc.tconv_causal_ref(*jargs[:4], jargs[4], mode != "repeat", rep)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_plain_b13_is_causal_and_batch_invariant() -> None:
    "Frame t reads frames <= t only (a prefix gives the prefix); an item alone gives its packed bits."
    x, w, b, stats, residual, _ = _inputs(2, "residual")
    full, full_raw = tfc.tconv_causal_ref(*(_torch(a) for a in (x, w, b, stats, residual)))
    head = (x[:, :2], w, b, stats[:, :2], residual[:, :2])
    prefix, prefix_raw = tfc.tconv_causal_ref(*(_torch(a) for a in head))
    assert torch.equal(prefix, full[:, :2]) and torch.equal(prefix_raw, full_raw[:, :2])
    item = (x[1:], w, b, stats[1:], residual[1:])
    alone, alone_raw = tfc.tconv_causal_ref(*(_torch(a) for a in item))
    assert torch.equal(alone, full[1:]) and torch.equal(alone_raw, full_raw[1:])


@pytest.mark.parametrize("mode", ["stats", "residual", "repeat"])
def test_the_function_gradients_match_jax_vjp(mode: str) -> None:
    """``tconv_causal_gn_silu`` under autograd: every input's gradient through the output and its
    statistics against ``jax.vjp`` of the JAX package's ``tconv_causal_ref`` (rtol 1e-4)."""
    x, w, b, stats, residual, rep = _inputs(3, mode)
    rng = np.random.default_rng(4)
    co = w.shape[-1]
    g = rng.standard_normal((B, T * rep, S, co), dtype=np.float32)
    g_raw = rng.standard_normal((B, T * rep, 2, co), dtype=np.float32) * 1e-3
    names = [n for n, a in zip(("x", "w", "b", "stats", "residual"), (x, w, b, stats, residual)) if a is not None]
    present = [a for a in (x, w, b, stats, residual) if a is not None]

    def ref(*args):
        full = dict(zip(names, args))
        return jfc.tconv_causal_ref(
            full["x"], full["w"], full["b"], full.get("stats"), full.get("residual"), stats is not None, rep
        )

    _, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in present))
    want = vjp((jnp.asarray(g), jnp.asarray(g_raw)))
    inputs = {n: _torch(a).requires_grad_(True) for n, a in zip(names, present)}
    out, raw = tfc.tconv_causal_gn_silu(
        inputs["x"], inputs["w"], inputs["b"], inputs.get("stats"), inputs.get("residual"), repeat_in=rep
    )
    torch.autograd.backward([out, raw], [torch.from_numpy(g), torch.from_numpy(g_raw)])
    for name, expected in zip(names, want):
        got = inputs[name].grad.numpy()
        scale = np.abs(np.asarray(expected)).max()
        np.testing.assert_allclose(got, np.asarray(expected), rtol=1e-4, atol=1e-5 * max(scale, 1.0), err_msg=name)


def test_launch_geometry_and_contract() -> None:
    """The statistics scratch has one [sum, sumsq] row per (item, output frame) and site tile of B13's
    plan (256 sites at the finest level and at the frame repeat, 64 at C = 256; 128 on the mma.sync
    route); ``repeat_in=2`` with statistics is refused, as in the JAX package."""
    assert tfc.tconv_partials_shape(1, 16, 262144, 64, 64, residual=True) == (16, 1024, 2, 64)
    assert tfc.tconv_partials_shape(1, 4, 65536, 128, 128, 3, 2) == (8, 256, 2, 128)
    assert tfc.tconv_partials_shape(2, 4, 4097, 256, 256) == (8, 65, 2, 256)
    assert tfc.tconv_partials_shape(2, 4, 4097, 20, 256) == (8, 33, 2, 256)
    x, w, b, stats, _, _ = _inputs(5, "stats")
    with pytest.raises(ValueError, match="stats must be None"):
        tfc.tconv_causal_gn_silu(_torch(x), _torch(w), _torch(b), _torch(stats), repeat_in=2)


def _emulate_frame_walk(x, w, b, stats=None, residual=None, rep=1):
    """B13 computed the way the wgmma kernel walks it (``tconv_plan``), in float64: per (item, walk,
    site run) the producer loads input frames jlo..jhi in order into a ring of ``frame_slots`` slots,
    each only once the output frame that last reads the slot's previous frame is done; the consumer
    normalizes a frame once when it first needs it, sums the k taps of each output frame from the
    slots, skips taps before frame 0, and frees a frame after its last reader.  Asserts that no slot is
    overwritten while a later output frame still reads it and that every needed frame is resident."""
    Bn, T_in, S, C = x.shape
    k, _, Co = w.shape
    plan = tfc.tconv_plan(T_in, S, C, Co, k, rep, residual is not None)
    T_out, bm = T_in * rep, plan.block_rows
    xin = x.double()
    if stats is not None:
        xin = tfc._normalize_silu(x.double(), stats[:, :, None, 0, :].double(), stats[:, :, None, 1, :].double())
    out = torch.zeros((Bn, T_out, S, Co), dtype=torch.float64)
    writes = torch.zeros((Bn, T_out, S), dtype=torch.int64)
    for bi in range(Bn):
        for seg in range(plan.segs):
            t0, t1 = seg * plan.walk, min(T_out, (seg + 1) * plan.walk)
            jlo, jhi = max(0, t0 - (k - 1)) // rep if t0 - (k - 1) >= 0 else 0, (t1 - 1) // rep
            last = {j: min(t1 - 1, j * rep + rep - 1 + k - 1) for j in range(jlo, jhi + 1)}
            for run in range(plan.runs):
                s0, s1 = run * bm, min(S, (run + 1) * bm)
                slots: dict[int, int | None] = dict.fromkeys(range(plan.frame_slots))
                done: set[int] = set()
                loaded = jlo
                for t in range(t0, t1):
                    # the producer runs ahead as far as free slots allow
                    while loaded <= jhi:
                        slot = (loaded - jlo) % plan.frame_slots
                        if slots[slot] is not None and slots[slot] not in done:
                            break
                        slots[slot] = loaded
                        loaded += 1
                    acc = torch.zeros((s1 - s0, Co), dtype=torch.float64)
                    for i in range(k):
                        if t - (k - 1) + i < 0:
                            continue
                        j = (t - (k - 1) + i) // rep
                        assert slots[(j - jlo) % plan.frame_slots] == j, "a frame read after its slot was reused"
                        acc += xin[bi, j, s0:s1] @ w[i].double()
                    out[bi, t, s0:s1] = acc + b.double()
                    writes[bi, t, s0:s1] += 1
                    done |= {j for j, tl in last.items() if tl == t}
    if residual is not None:
        out = out + residual.double()
    return out, writes


@pytest.mark.parametrize(("T_in", "S", "rep", "mode"), [(5, 333, 1, "stats"), (2, 200, 2, "repeat"), (1, 70, 1, "residual"),
                                                       (16, 40, 1, "stats"), (3, 64, 2, "repeat")])
def test_frame_walk_emulation_matches_plain(T_in: int, S: int, rep: int, mode: str) -> None:
    """The wgmma frame walk's bookkeeping, on the CPU: frame slots reused only after their last reader,
    the window moving every output frame (rep 1) or every second (rep 2), causal taps skipped, walks
    that do not divide T and site runs that do not divide S; every output written once and equal to
    the plain version (rtol/atol 1e-5)."""
    rng = np.random.default_rng(T_in * 7 + S)
    x = (rng.standard_normal((2, T_in, S, 16), dtype=np.float32) + 0.3).astype(np.float32)
    w = (rng.standard_normal((3, 16, 24), dtype=np.float32) / 7).astype(np.float32)
    b = (0.1 * rng.standard_normal(24)).astype(np.float32)
    stats = residual = None
    if mode != "repeat":
        stats = tfc.finalize_group_stats(tfc.channel_stats(torch.from_numpy(x).reshape(2 * T_in, S, 16)), 4, S)
        stats = stats.reshape(2, T_in, 2, 16)
    if mode == "residual":
        residual = torch.from_numpy(rng.standard_normal((2, T_in, S, 24), dtype=np.float32))
    got, writes = _emulate_frame_walk(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), stats, residual, rep)
    want, _ = tfc.tconv_causal_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), stats, residual, rep)
    assert torch.equal(writes, torch.ones_like(writes))
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    ("T_in", "S", "C", "co", "rep"),
    [(16, 262144, 64, 64, 1), (8, 65536, 128, 128, 2), (4, 4096, 256, 256, 1), (4, 16384, 256, 256, 2),
     (1, 333, 64, 64, 1), (5, 333, 128, 128, 2)],
)
def test_tconv_plan_invariants(T_in: int, S: int, C: int, co: int, rep: int) -> None:
    """B13's wgmma plan: BN covers Co exactly, at most 256 sites a tile (a TMA box), runs that cover S
    once, walks that cover the output frames once, enough frame slots that the walk never waits on
    itself (slots * rep > rep + k - 2), shared memory within 227 KB, at least ~132 tiles an item where
    the shape has them (the mid level's (4, 4096, 256) walks 2 frames, the finest level all 16), and a
    plan that is a function of (T, S, C, Co, k, rep) alone."""
    plan = tfc.tconv_plan(T_in, S, C, co, 3, rep)
    T_out = T_in * rep
    assert plan.route == "wgmma" and plan.n_tiles * plan.bn == -(-co // 8) * 8
    assert plan.block_rows <= 256 and (plan.runs - 1) * plan.block_rows < S <= plan.runs * plan.block_rows
    assert (plan.segs - 1) * plan.walk < T_out <= plan.segs * plan.walk
    assert plan.frame_slots * rep > rep + 1 and plan.frame_slots >= tfc._frames_read(3, rep)
    assert plan.smem <= 232448 and plan.resident == (plan.b_stages == 3 * -(-C // 64) and plan.n_tiles == 1)
    tiles = plan.runs * plan.n_tiles * plan.segs
    assert tiles >= 0.9 * 132 or plan.walk == 1  # ~132: the walk divides T_out into whole segments
    assert tfc.tconv_partials_shape(3, T_in, S, C, co, 3, rep) == (3 * T_out, plan.runs, 2, co)
    if (T_in, S, C) == (16, 262144, 64):
        assert plan.walk == 16
    if (T_in, S, C) == (4, 4096, 256):
        assert plan.walk == 2 and tiles >= 128
    assert tfc.tconv_plan(T_in, S, 12, co, 3, rep).route == "mma_sync"
