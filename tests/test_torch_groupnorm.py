"""The port's channels-last GroupNorm (kernel B8's plain version and its
autograd Function) against the JAX package's, on the same numpy inputs.

On the CPU ``groupnorm_forward`` is the plain version, so these tests hold
the arithmetic the kernel must reproduce: centered f32 statistics, the f32
affine before the SiLU, one rounding.  The kernel itself is held to the
plain version on the card (``tests/test_torch_kernels.py``,
``chip_smoke.py``).
"""

from __future__ import annotations

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skrample_tpu_torch.ops import groupnorm as tgn

jgn = importlib.import_module("skrample_tpu.ops.groupnorm")


def _inputs(shape: tuple[int, int, int], seed: int, affine: bool) -> tuple[np.ndarray, ...]:
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape, dtype=np.float32) * 2.0 + 0.3).astype(np.float32)
    if not affine:
        return x, None, None
    C = shape[-1]
    scale = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    return x, scale, bias


def _torch(a: np.ndarray | None, dtype: torch.dtype = torch.float32) -> torch.Tensor | None:
    return None if a is None else torch.from_numpy(a).to(dtype)


def _jax(a: np.ndarray | None, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a).astype(dtype)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("fuse_silu", [False, True])
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize(("shape", "groups"), [((2, 48, 320), 32), ((1, 40, 96), 8)])
def test_plain_matches_jax_reference(shape, groups, affine: bool, fuse_silu: bool, eps: float) -> None:
    """f32, rtol 1e-5 (atol 1e-6 near zero): the same centered statistics summed in another
    order.  C = 320 over 32 groups has the SDXL level-1 group size of 10."""
    x, scale, bias = _inputs(shape, groups + shape[-1], affine)
    want = jgn.groupnorm_reference(_jax(x), groups, fuse_silu, eps, _jax(scale), _jax(bias))
    got = tgn.groupnorm_forward(_torch(x), groups, fuse_silu, eps, _torch(scale), _torch(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fuse_silu", [False, True])
@pytest.mark.parametrize(("shape", "groups", "affine"), [((2, 64, 128), 16, False), ((1, 32, 256), 32, True)])
def test_plain_matches_the_pallas_kernel(dtype: str, fuse_silu: bool, shape, groups: int, affine: bool) -> None:
    """Against the TPU kernel in interpret mode at C % 128 == 0: atol 2e-5 in f32 and 1e-2 in bf16,
    the JAX package's own bounds for its kernel (tests/test_ops.py)."""
    x, scale, bias = _inputs(shape, 7, affine)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)
    want = jgn.groupnorm_forward(_jax(x, jdt), groups, fuse_silu, True, 1e-5, _jax(scale), _jax(bias))
    got = tgn.groupnorm_forward(_torch(x, tdt), groups, fuse_silu, 1e-5, _torch(scale), _torch(bias))
    assert got.dtype == tdt
    atol = 2e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)


@pytest.mark.parametrize("fuse_silu", [False, True])
@pytest.mark.parametrize(("shape", "groups"), [((2, 512, 64), 16), ((1, 256, 320), 32)])
def test_plain_matches_the_uncentered_form(fuse_silu: bool, shape, groups: int) -> None:
    """The plain version in bf16 against the JAX package's three-pass groupnorm_eager_bign (what
    the TPU runs past its kernel's VMEM cap): atol 2e-2, that test's bound (tests/test_ops.py);
    the port's own copy of the three-pass form agrees with JAX's to rtol 1e-5 in f32."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(shape, dtype=np.float32) * 3.0 + 1.7).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    bias = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    want = jgn.groupnorm_eager_bign(_jax(x, jnp.bfloat16), groups, fuse_silu, 1e-6, _jax(scale), _jax(bias))
    got = tgn.groupnorm_forward(_torch(x, torch.bfloat16), groups, fuse_silu, 1e-6, _torch(scale), _torch(bias))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2)
    mine = tgn.groupnorm_eager_bign(_torch(x), groups, fuse_silu, 1e-6, _torch(scale), _torch(bias))
    theirs = jgn.groupnorm_eager_bign(_jax(x), groups, fuse_silu, 1e-6, _jax(scale), _jax(bias))
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("fuse_silu", [False, True])
def test_function_gradients_match_jax_vjp(affine: bool, fuse_silu: bool) -> None:
    """``groupnorm_cl``'s gradients (x, scale, bias) against ``jax.vjp`` of the JAX dispatch on a
    (B, H, W, C) activation: rtol 1e-4 (atol 1e-5 of the largest), f32."""
    rng = np.random.default_rng(5)
    x, scale, bias = _inputs((2, 6 * 5, 96), 11, affine)
    x = x.reshape(2, 6, 5, 96)
    g = rng.standard_normal(x.shape, dtype=np.float32)
    groups, eps = 8, 1e-5

    def jfn(*args):
        s, b = (args[1], args[2]) if affine else (None, None)
        return jgn.groupnorm_cl(args[0], groups, fuse_silu, eps, s, b)

    jargs = [_jax(a) for a in (x, scale, bias) if a is not None]
    want_out, vjp = jax.vjp(jfn, *jargs)
    want = vjp(jnp.asarray(g))

    targs = [torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias) if a is not None]
    s, b = (targs[1], targs[2]) if affine else (None, None)
    out = tgn.groupnorm_cl(targs[0], groups, fuse_silu, eps, s, b)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-6)
    for mine, theirs in zip(targs, want):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(mine.grad.numpy(), theirs, rtol=1e-4, atol=1e-5 * np.abs(theirs).max())


@pytest.mark.parametrize(
    ("batch", "n", "c", "dtype"),
    [
        (4, 16384, 320, torch.bfloat16),
        (4, 4096, 960, torch.bfloat16),
        (4, 1024, 2560, torch.bfloat16),
        (2, 64, 1920, torch.float32),
        (1, 5, 3, torch.float32),
        (3, 1000, 30, torch.bfloat16),
    ],
)
def test_launch_geometry(batch: int, n: int, c: int, dtype: torch.dtype) -> None:
    """B8's grid: a block owns whole rows (row lanes x channel vectors, the fewest row lanes that make
    256 threads, at most 1024), 16-byte vectors only where C allows them, chunks of rows that cover N with
    none empty, one wave of statistics blocks at batch 4 where N allows it (at least half
    the chunks asked for: rounding the rows up can merge some), and the same split at every batch size
    (an item's statistics do not depend on its batch); an unaligned tensor takes 1-channel vectors, and
    a row of more than 1024 of them is refused."""
    vec, lanes, rows, chunks = tgn.launch_geometry(batch, n, c, dtype)
    wide = 16 // torch.empty((), dtype=dtype).element_size()
    assert vec == (wide if c % wide == 0 else 1)
    vectors = c // vec
    assert 256 <= lanes * vectors <= 1024 and (lanes - 1) * vectors < 256
    assert (chunks - 1) * rows < n <= chunks * rows
    asked = min(
        tgn._MAX_CHUNKS,
        max(-(-tgn._SMS * (tgn._SM_THREADS // (lanes * vectors)) // 4), -(-n // tgn._LONG_CHUNK)),
        math.ceil(n / (lanes * tgn._ROWS_IN_FLIGHT[vec])),
    )
    assert 2 * chunks >= asked and chunks <= tgn._MAX_CHUNKS
    assert all(tgn.launch_geometry(b, n, c, dtype) == (vec, lanes, rows, chunks) for b in (1, 2, 8))
    if c <= 1024:
        assert tgn.launch_geometry(batch, n, c, dtype, aligned=False)[0] == 1
    else:
        with pytest.raises(ValueError, match="vectors"):
            tgn.launch_geometry(batch, n, c, dtype, aligned=False)


def _emulate_b8(x: torch.Tensor, groups: int, eps: float, geometry: tuple[int, int, int, int]) -> torch.Tensor:
    """Each channel's ``[mean, inv]`` ``(B, 2, C)`` the way B8 reduces them, in float32: per (chunk, row
    lane, channel) a Welford mean and M2 over the lane's rows in order; the row lanes merged per channel,
    then the channels per group, then the chunks per group in chunk order, each by a two-pass merge about
    the merged mean."""
    vec, lanes, rows, chunks = geometry
    B, N, C = x.shape
    cg = C // groups
    out = []
    for item in x.float():
        means, m2s, counts = [], [], []
        for k in range(chunks):
            xs = item[k * rows : min(N, (k + 1) * rows)]
            r = xs.shape[0]
            steps = -(-r // lanes)
            pad = torch.cat([xs, torch.zeros(steps * lanes - r, C)]).reshape(steps, lanes, C)
            n_lane = torch.tensor([len(range(lane, r, lanes)) for lane in range(lanes)], dtype=torch.float32)[:, None]
            mean = torch.zeros(lanes, C)
            m2 = torch.zeros(lanes, C)
            for i in range(steps):
                live = (i < n_lane).float()
                n = torch.full((lanes, 1), float(i + 1))
                delta = pad[i] - mean
                mean = mean + live * delta / n
                m2 = m2 + live * delta * (pad[i] - mean)
            mu_c = (n_lane * mean).sum(0) / r
            q_c = (m2 + n_lane * (mean - mu_c) ** 2).sum(0)
            mu_g = mu_c.reshape(groups, cg).sum(-1) / cg
            q_g = (q_c.reshape(groups, cg) + r * (mu_c.reshape(groups, cg) - mu_g[:, None]) ** 2).sum(-1)
            means.append(mu_g)
            m2s.append(q_g)
            counts.append(float(r * cg))
        n_k = torch.tensor(counts)[:, None]
        mean_k, m2_k = torch.stack(means), torch.stack(m2s)
        mu = (n_k * mean_k).sum(0) / (N * cg)
        var = (m2_k + n_k * (mean_k - mu) ** 2).sum(0) / (N * cg)
        inv = 1.0 / torch.sqrt(var + eps)
        out.append(torch.stack([mu.repeat_interleave(cg), inv.repeat_interleave(cg)]))
    return torch.stack(out)


@pytest.mark.parametrize(
    ("shape", "groups", "dtype"), [((8, 300, 40), 4, torch.bfloat16), ((2, 1000, 320), 32, torch.float32)]
)
def test_b8_statistics_order_matches_plain(shape, groups: int, dtype: torch.dtype) -> None:
    """B8's statistics order (Welford per row lane, then lanes, channels and chunks merged about their
    merged means), emulated in float32 at the kernel's own split, normalizes within 1e-5 of the plain
    version's largest output (f32: the same centered statistics in another order); groups of 10
    channels (C = 320) and of 10 with one 8-channel vector straddling two (C = 40 over 4).  The split is
    the same at batch 1, 2, 4 and 8, so an item's statistics are the same bits at every batch size."""
    x, scale, bias = _inputs(shape, sum(shape), True)
    xt = _torch(x, dtype)
    geometry = tgn.launch_geometry(shape[0], shape[1], shape[2], dtype)
    assert geometry[3] > 1  # more than one chunk: the chunk merge runs
    stats = _emulate_b8(xt, groups, 1e-5, geometry)
    y = (xt.float() - stats[:, None, 0]) * stats[:, None, 1] * _torch(scale) + _torch(bias)
    y = (y * torch.sigmoid(y)).to(dtype)
    want = tgn.groupnorm_reference(xt, groups, True, 1e-5, _torch(scale), _torch(bias))
    tol = 1e-5 if dtype == torch.float32 else 2**-7
    assert (y.float() - want.float()).abs().max().item() <= tol * want.float().abs().max().item()
    for b in (1, 2, 4):
        assert tgn.launch_geometry(b, shape[1], shape[2], dtype) == geometry
        assert torch.equal(_emulate_b8(xt[:1], groups, 1e-5, geometry)[0], stats[0])


def test_groupnorm_cl_refuses_groups_that_do_not_divide() -> None:
    with pytest.raises(ValueError, match="groups"):
        tgn.groupnorm_cl(torch.zeros(1, 4, 4, 30), 8)
