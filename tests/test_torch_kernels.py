"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips (inside the test, through the
``cuda`` fixture) where there is no CUDA device: the kernels have no CPU
mode, and their CPU path is the plain version itself.  This file imports
neither jax nor the JAX package, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from skrample_tpu_torch.ops import adaln, flash_attention, fused


@pytest.fixture
def cuda() -> torch.device:
    "The card, or a skip: kernel tests need CUDA (decided here, never at import)."
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# ---- the kernels on the card -------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize(
    ("dtype", "rows", "K"),
    [(torch.float32, 1, 4), (torch.float32, 3, 7), (torch.bfloat16, 1, 4), (torch.bfloat16, 3, 15)],
)
def test_fused_step_kernel_matches_plain(cuda: torch.device, dtype: torch.dtype, rows: int, K: int) -> None:
    """K1 rounds every product and sum in the plain chain's order: bit-identical, tolerance 0.

    Two shapes: the slice's latent (16-byte vectors throughout) and a ragged
    one whose output rows are misaligned (the scalar path)."""
    gen = torch.Generator(cuda).manual_seed(rows * K)
    w = np.random.default_rng(K).standard_normal((rows, K))
    for shape in ((4, 4, 64, 64), (3, 5, 7, 11)):
        basis = [torch.randn(shape, generator=gen, device=cuda).to(dtype) for _ in range(K)]
        before = fused.fused_step_cuda.launches
        got = fused.fused_step_cuda(w, basis)
        assert fused.fused_step_cuda.launches == before + 1
        assert torch.equal(got, fused.fused_step(w, basis))


@pytest.mark.gpu
def test_fused_step_kernel_raises_on_what_it_cannot_take(cuda: torch.device) -> None:
    x = torch.zeros(16, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        fused.fused_step_cuda([[1.0, 1.0]], [x, x])
    y = torch.zeros(4, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fused.fused_step_cuda([[1.0, 1.0]], [y, y.t()])
    with pytest.raises(ValueError, match="host-side"):
        fused.fused_step_cuda(torch.ones(1, 2, device=cuda), [y, y])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_qkv_attention_kernel_matches_plain(cuda: torch.device, dtype: torch.dtype) -> None:
    "K2 vs the plain attention in the same 16-bit inputs: atol 5e-3 (probabilities round to 16 bits at other points)."
    gen = torch.Generator(cuda).manual_seed(0)
    qkv = torch.randn((2, 512, 3 * 4 * 128), generator=gen, device=cuda).to(dtype)
    got = flash_attention.flash_attention_qkv_forward(qkv, 4)
    ref = flash_attention._qkv_reference(qkv, 4)
    assert (got.float() - ref.float()).abs().max().item() <= 5e-3


@pytest.mark.gpu
def test_qkv_attention_kernel_raises_on_what_it_cannot_take(cuda: torch.device) -> None:
    with pytest.raises(ValueError, match="dtype"):
        flash_attention.flash_attention_qkv_forward(torch.zeros(1, 128, 768, device=cuda), 2)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention_qkv_forward(torch.zeros(1, 128, 384, device=cuda, dtype=torch.bfloat16), 2)
    with pytest.raises(ValueError, match="multiple of 64"):
        flash_attention.flash_attention_qkv_forward(torch.zeros(1, 96, 768, device=cuda, dtype=torch.bfloat16), 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adaln_kernel_matches_plain(cuda: torch.device, dtype: torch.dtype) -> None:
    "K3 vs the plain adaLN: one rounding of the same f32 value, up to one ulp of the output dtype."
    gen = torch.Generator(cuda).manual_seed(1)
    x = (torch.randn((2, 256, 768), generator=gen, device=cuda) * 2).to(dtype)
    mods = torch.randn((2, 3 * 768), generator=gen, device=cuda).to(dtype)
    shift, scale = mods[:, :768], mods[:, 1536:]
    got = adaln.adaln_forward(x, shift, scale)
    ref = adaln.adaln_reference(x, shift, scale)
    rel = 1e-5 if dtype == torch.float32 else 2**-7
    assert (got.float() - ref.float()).abs().max().item() <= rel * ref.float().abs().max().item()


@pytest.mark.gpu
def test_adaln_kernel_raises_on_what_it_cannot_take(cuda: torch.device) -> None:
    x = torch.zeros(1, 8, 128, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        adaln.adaln_forward(x, x[:, 0], x[:, 0])
    x = torch.zeros(1, 8, 128 * 7, device=cuda)
    with pytest.raises(ValueError, match="no kernel instance"):
        adaln.adaln_forward(x, x[:, 0], x[:, 0])
    x = torch.zeros(1, 8, 128, device=cuda)
    with pytest.raises(ValueError, match="shift"):
        adaln.adaln_forward(x, x[:, 0].to(torch.bfloat16), x[:, 0])


@pytest.mark.gpu
def test_denoiser_kernel_path_is_bit_identical_to_the_plain_chain(cuda: torch.device) -> None:
    "A 12-step UniPC-SDE loop (rows 3, ring noise): K1 per step vs the plain chain, tolerance 0."
    from skrample_tpu_torch import scheduling
    from skrample_tpu_torch.ops import CompiledDenoiser, compile_sampler
    from skrample_tpu_torch.sampling import models, structured

    compiled = compile_sampler(
        structured.UniPC(order=3, stochasticity=0.5), scheduling.FlowShift(scheduling.Linear()), models.FlowModel(), 12
    )
    gen = torch.Generator(cuda).manual_seed(2)
    x0 = torch.randn((2, 4, 32, 32), generator=gen, device=cuda)
    noises = torch.randn((12, 2, 4, 32, 32), generator=gen, device=cuda)

    def model_fn(x, t, s, a):
        return torch.tanh(x) * (1 + s) - 0.1 * a

    outs = {}
    for kernel in ("cuda", "torch"):
        denoiser = CompiledDenoiser.build(compiled, kernel=kernel, device=cuda)
        before = fused.fused_step_cuda.launches
        outs[kernel] = denoiser.run(model_fn, x0, noises=noises)
        assert fused.fused_step_cuda.launches - before == (12 if kernel == "cuda" else 0)
    assert torch.equal(outs["cuda"], outs["torch"])


@pytest.mark.gpu
def test_dit_forward_through_the_kernels(cuda: torch.device) -> None:
    """A bf16 DiT forward launches K2 once per block and K3 2*depth+1 times,
    and agrees with the same forward through the plain versions to 3e-2 of
    its largest value (bf16 rounding at other points, over two blocks)."""
    from unittest import mock

    from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree

    config = DiTConfig(dim=256, depth=2, heads=2, compute_dtype=torch.bfloat16, attention="flash")
    model = DiT(config, device=cuda).load_jax_params(random_param_tree(config, 0))
    x = torch.randn((2, 4, 32, 32), generator=torch.Generator(cuda).manual_seed(4), device=cuda)
    t = torch.tensor([700.0, 30.0], device=cuda)
    k2, k3 = flash_attention.flash_attention_qkv_forward.launches, adaln.adaln_forward.launches
    with torch.inference_mode():
        got = model(x, t)
        assert flash_attention.flash_attention_qkv_forward.launches - k2 == config.depth
        assert adaln.adaln_forward.launches - k3 == 2 * config.depth + 1
        with (
            mock.patch.object(flash_attention, "flash_attention_qkv_forward", flash_attention._qkv_reference),
            mock.patch.object(adaln, "adaln_forward", adaln.adaln_reference),
        ):
            want = model(x, t)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 3e-2 * want.abs().max().item()
