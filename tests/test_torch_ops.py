"""The port's ops against the JAX package's, and its kernels against their plain versions.

Inputs are drawn with numpy from a seed and handed to both packages.  The
JAX side runs as its own CPU tests run it: the Pallas kernels in interpret
mode.  The port's plain versions run on the CPU here; the CUDA kernels are
held to them on the card in ``test_torch_kernels.py``.
"""

from __future__ import annotations

import importlib
import pathlib

import jax  # noqa: F401 — conftest pins it to the CPU; the JAX package below needs it
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skrample_tpu import scheduling as jsched
from skrample_tpu.ops import adaln as jadaln
from skrample_tpu.ops import compiler as jcomp
from skrample_tpu.ops import fused as jfused
from skrample_tpu.ops import loop as jloop
from skrample_tpu.sampling import models as jmodels
from skrample_tpu.sampling import structured as jstruct
from skrample_tpu_torch import scheduling as tsched
from skrample_tpu_torch.ops import _cuda, adaln, flash_attention, fused, loop
from skrample_tpu_torch.ops import compiler as tcomp
from skrample_tpu_torch.sampling import models as tmodels
from skrample_tpu_torch.sampling import structured as tstruct

# the JAX package's ops/__init__ re-exports a function under the module's name
jflash = importlib.import_module("skrample_tpu.ops.flash_attention")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- K1: fused step ----------------------------------------------------------


@pytest.mark.parametrize("K", [2, 4, 15])
@pytest.mark.parametrize("rows", [1, 3])
def test_fused_step_matches_jax(rows: int, K: int) -> None:
    """Plain chain vs the JAX chain and the Pallas kernel (interpret mode).

    f32, rtol 1e-6: the same multiply-add chain in the same order; XLA may
    contract a multiply and an add into one FMA where PyTorch rounds twice."""
    rng = np.random.default_rng(rows * 100 + K)
    weights = rng.standard_normal((rows, K))
    stack = rng.standard_normal((K, 2, 4, 8, 16), dtype=np.float32)
    port = fused.fused_step(weights, _t(stack)).numpy()
    ref = np.asarray(jfused.fused_step(jnp.asarray(weights, jnp.float32), jnp.asarray(stack)))
    pallas = np.asarray(jfused.fused_step_pallas(jnp.asarray(weights, jnp.float32), jnp.asarray(stack), interpret=True))
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port, pallas, rtol=1e-6, atol=1e-6)


def test_fused_step_cuda_on_cpu_is_the_plain_chain() -> None:
    "On CPU tensors the kernel wrapper is the plain version, exactly, and launches nothing."
    rng = np.random.default_rng(7)
    weights = rng.standard_normal((3, 5))
    basis = [_t(rng.standard_normal((2, 4, 8, 8), dtype=np.float32)) for _ in range(5)]
    before = fused.fused_step_cuda.launches
    assert torch.equal(fused.fused_step_cuda(weights, basis), fused.fused_step(weights, basis))
    assert fused.fused_step_cuda.launches == before


def test_kernel_wrappers_refuse_non_cpu_tensors_without_a_kernel() -> None:
    "A tensor off the CPU never falls back to the plain version: on a device with no kernel they raise."
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused.fused_step_cuda([[1.0, 2.0]], [torch.empty(8, device=meta)] * 2)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention.flash_attention_qkv_forward(torch.empty(1, 64, 768, device=meta), 2)
    with pytest.raises(ValueError, match="unsupported device"):
        mod = torch.empty(1, 128, device=meta)
        adaln.adaln_forward(torch.empty(1, 8, 128, device=meta), mod, mod)
    with pytest.raises(ValueError, match="host-side"):
        fused.host_rows(torch.empty(1, 2, device=meta), torch.float32)


def test_library_build_fails_loudly_without_nvcc(tmp_path, monkeypatch) -> None:
    "Without a CUDA toolkit the build raises; nothing pretends a kernel exists."
    monkeypatch.setenv("SKRAMPLE_TPU_TORCH_BUILD", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("NVCC", raising=False)
    monkeypatch.setattr(_cuda, "_lib", None)
    if pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.library()
    assert not list(tmp_path.glob("*.so"))


def test_build_digest_tracks_the_sources(tmp_path, monkeypatch) -> None:
    "The library's name hashes every source and header and the flags: an edited kernel never loads a stale build."
    digest = _cuda._digest()
    assert digest == _cuda._digest() and len(digest) == 16
    sources = [src for src in _cuda.CSRC.iterdir() if src.suffix in (".cu", ".cuh")]
    assert {src.name for src in sources} >= set(_cuda.SOURCES)
    for src in sources:
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    assert _cuda._digest() == digest
    for name in ("adaln.cu", "tile_mma.cuh"):
        (tmp_path / name).write_bytes((tmp_path / name).read_bytes() + b"\n// edited\n")
        assert _cuda._digest() != digest
        digest = _cuda._digest()


# ---- the sampler loop ----------------------------------------------------------


@pytest.mark.parametrize("name", ["DPM2", "UniPC3-SDE", "Adams4"])
def test_denoiser_step_matches_jax(name: str) -> None:
    """One CompiledDenoiser.step per step of a whole table, port vs JAX, f32.

    rtol 1e-6: the same chain of f32 multiply-adds (see the fused-step test);
    exercises the trivial-store (rows 1), synthesized-store (rows 3) and
    ring-noise (3 slots) variants."""
    def sampler(pkg):
        return {
            "DPM2": lambda: pkg.DPM(order=2),
            "UniPC3-SDE": lambda: pkg.UniPC(order=3, stochasticity=0.5),
            "Adams4": lambda: pkg.Adams(order=4),
        }[name]()

    jc = jcomp.compile_sampler(sampler(jstruct), jsched.FlowShift(jsched.Linear()), jmodels.FlowModel(), 6)
    tc = tcomp.compile_sampler(sampler(tstruct), tsched.FlowShift(tsched.Linear()), tmodels.FlowModel(), 6)
    jd = jloop.CompiledDenoiser.build(jc, kernel="xla")
    td = loop.CompiledDenoiser.build(tc, device="cpu")
    assert (jd.rows, jd.slots) == (td.rows, td.slots)
    np.testing.assert_array_equal(np.asarray(jd.weights), td.weights.numpy())

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 8, 8), dtype=np.float32)
    jx, tx = jnp.asarray(x), _t(x)
    jring, tring = jd.init_ring(jx), td.init_ring(tx)
    for n in range(6):
        o = rng.standard_normal(x.shape, dtype=np.float32)
        z = rng.standard_normal(x.shape, dtype=np.float32) if td.requires_noise else None
        jx, jring = jd.step(jd.weights[n], jx, jnp.asarray(o), jring, None if z is None else jnp.asarray(z))
        tx, tring = td.step(td.host_weights[n], tx, _t(o), tring, None if z is None else _t(z))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
        for a, b in zip(tring, jring, strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_denoiser_step_batched_matches_jax() -> None:
    "Per-item weights: each batch row at its own step index; f32 rtol 1e-6 (same chain)."
    jc = jcomp.compile_sampler(jstruct.DPM(order=2), jsched.FlowShift(jsched.Linear()), jmodels.FlowModel(), 8)
    tc = tcomp.compile_sampler(tstruct.DPM(order=2), tsched.FlowShift(tsched.Linear()), tmodels.FlowModel(), 8)
    jd = jloop.CompiledDenoiser.build(jc, kernel="xla")
    td = loop.CompiledDenoiser.build(tc, device="cpu")
    rng = np.random.default_rng(5)
    x, o = (rng.standard_normal((3, 4, 8, 8), dtype=np.float32) for _ in range(2))
    ring = [rng.standard_normal(x.shape, dtype=np.float32) for _ in range(td.history * td.slots)]
    idx = np.array([1, 4, 7])
    jx, _ = jd.step_batched(jd.weights[idx], jnp.asarray(x), jnp.asarray(o), tuple(map(jnp.asarray, ring)))
    tx, _ = td.step_batched(td.weights[idx], _t(x), _t(o), tuple(map(_t, ring)))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)


def test_denoiser_rejects_unknown_kernel() -> None:
    tc = tcomp.compile_sampler(tstruct.Euler(), tsched.Linear(), tmodels.FlowModel(), 4)
    with pytest.raises(ValueError, match="unknown kernel"):
        loop.CompiledDenoiser.build(tc, kernel="pallas", device="cpu")


# ---- K3: adaLN -------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 64, 128), (1, 256, 384)])
def test_adaln_matches_jax_kernel(shape: tuple[int, int, int]) -> None:
    """Plain adaLN vs the JAX Pallas kernel (interpret mode) and the JAX reference.

    f32, 1e-5: the same float32 statistics, summed in another order."""
    rng = np.random.default_rng(sum(shape))
    B, N, D = shape
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    shift = rng.standard_normal((B, D), dtype=np.float32)
    scale = rng.standard_normal((B, D), dtype=np.float32)
    port = adaln.adaln_reference(_t(x), _t(shift), _t(scale)).numpy()
    pallas = np.asarray(jadaln.adaln_forward(jnp.asarray(x), jnp.asarray(shift), jnp.asarray(scale), interpret=True))
    ref = np.asarray(jadaln.adaln_reference(jnp.asarray(x), jnp.asarray(shift), jnp.asarray(scale)))
    np.testing.assert_allclose(port, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(adaln.adaln_modulate(_t(x), _t(shift), _t(scale)).numpy(), port, rtol=0, atol=0)


@pytest.mark.parametrize(("shape", "kernel"), [((1, 64, 128), True), ((1, 64, 96), False), ((1, 12, 128), False)])
def test_adaln_dispatch_rule(shape: tuple[int, int, int], kernel: bool, monkeypatch) -> None:
    "The JAX rule: the kernel only for D % 128 == 0 and N divisible by one of 256..8."
    calls = []
    monkeypatch.setattr(adaln, "adaln_forward", lambda *a: calls.append(a) or adaln.adaln_reference(*a))
    B, N, D = shape
    adaln.adaln_modulate(torch.zeros(shape), torch.zeros(B, D), torch.zeros(B, D))
    assert bool(calls) == kernel


# ---- K2: fused-qkv attention ------------------------------------------------------


@pytest.mark.parametrize(("B", "N", "H"), [(1, 128, 2), (2, 256, 1)])
def test_qkv_attention_matches_jax_kernel(B: int, N: int, H: int) -> None:
    """Plain fused-qkv attention vs the JAX Pallas kernel (interpret mode), f32, 1e-5.

    Both compute float32 scores and softmax; the kernel normalises lazily
    and in the log2 domain, so the sums differ in the last bits."""
    rng = np.random.default_rng(B * N + H)
    qkv = rng.standard_normal((B, N, 3 * H * 128), dtype=np.float32)
    port = flash_attention._qkv_reference(_t(qkv), H).numpy()
    pallas = np.asarray(jflash.flash_attention_qkv_forward(jnp.asarray(qkv), H, interpret=True))
    np.testing.assert_allclose(port, pallas, rtol=1e-5, atol=1e-5)
    ref = np.asarray(jflash._qkv_reference(jnp.asarray(qkv), H))
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    ("shape", "heads", "kernel"), [((1, 128, 768), 2, True), ((1, 128, 384), 2, False), ((1, 96, 768), 2, False)]
)
def test_qkv_attention_dispatch_rule(shape: tuple[int, int, int], heads: int, kernel: bool, monkeypatch) -> None:
    "The JAX rule: the kernel for head_dim % 128 == 0 and N % 128 == 0, plain attention otherwise."
    calls = []
    monkeypatch.setattr(
        flash_attention, "flash_attention_qkv_forward", lambda *a: calls.append(a) or flash_attention._qkv_reference(*a)
    )
    flash_attention.flash_attention_qkv(torch.zeros(shape), heads)
    assert bool(calls) == kernel


def test_attention_reference_matches_jax() -> None:
    "(B, H, N, d) plain attention vs the JAX einsum oracle, f32 1e-5."
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, 3, 64, 32), dtype=np.float32) for _ in range(3))
    port = flash_attention.attention_reference(_t(q), _t(k), _t(v)).numpy()
    ref = np.asarray(jflash.attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5)
