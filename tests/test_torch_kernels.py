"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips (inside the test, through the
``cuda`` fixture) where there is no CUDA device: the kernels have no CPU
mode, and their CPU path is the plain version itself.  This file imports
neither jax nor the JAX package, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from skrample_tpu_torch.ops import adaln, flash_attention, fused, fused_conv, groupnorm, quant, rope


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
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention_qkv_forward(torch.zeros(1, 768, 96, device=cuda, dtype=torch.bfloat16).mT, 2)


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


# ---- the training slice's kernels: K4, K5, K6 ------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_qkv_attention_lse_kernel_matches_plain(cuda: torch.device, dtype: torch.dtype) -> None:
    """K4 vs its plain version: o atol 5e-3 as K2 (and bit-identical to K2: the same body);
    lse atol 1e-3 (f32 statistics summed in another order, the hardware's exp2)."""
    gen = torch.Generator(cuda).manual_seed(5)
    qkv = torch.randn((2, 512, 3 * 4 * 128), generator=gen, device=cuda).to(dtype)
    before = flash_attention.flash_attention_qkv_forward_lse.launches
    o, lse = flash_attention.flash_attention_qkv_forward_lse(qkv, 4)
    assert flash_attention.flash_attention_qkv_forward_lse.launches == before + 1
    ro, rlse = flash_attention._qkv_reference_lse(qkv, 4)
    assert lse.shape == (2, 4, 512, 1) and lse.dtype == torch.float32
    assert (o.float() - ro.float()).abs().max().item() <= 5e-3
    assert (lse - rlse).abs().max().item() <= 1e-3
    assert torch.equal(o, flash_attention.flash_attention_qkv_forward(qkv, 4))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("N", [64, 100, 512, 1000, 1024])
def test_qkv_attention_backward_kernel_matches_plain(cuda: torch.device, N: int, dtype: torch.dtype) -> None:
    """K5 vs its plain version on the same (qkv, o, lse, g) at tiled and ragged N, each third
    (dq from one kernel, dk and dv from the other) within 2e-2 of its largest value: the outputs
    round to 16 bits, and P and dS round to 16 bits from f32 values summed in another order.  The
    launch counts on the wgmma route, and a second call gives the same bits (no atomics: every
    output element is written once by one block)."""
    gen = torch.Generator(cuda).manual_seed(6)
    qkv = torch.randn((2, N, 3 * 4 * 128), generator=gen, device=cuda).to(dtype)
    g = torch.randn((2, N, 4 * 128), generator=gen, device=cuda).to(dtype)
    o, lse = flash_attention.flash_attention_qkv_forward_lse(qkv, 4)
    wrapper = flash_attention.flash_attention_qkv_backward
    before = wrapper.launches, dict(wrapper.routes)
    got = wrapper(qkv, o, lse, g, 4)
    assert wrapper.launches == before[0] + 1 and wrapper.routes == {"wgmma": before[1]["wgmma"] + 1}
    ref = flash_attention._qkv_backward_reference(qkv, o, lse, g, 4)
    for part, want in zip(got.chunk(3, dim=-1), ref.chunk(3, dim=-1)):
        scale = want.float().abs().max().item()
        assert scale > 0 and torch.isfinite(part).all()
        assert (part.float() - want.float()).abs().max().item() <= 2e-2 * scale
    assert torch.equal(wrapper(qkv, o, lse, g, 4), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adaln_backward_kernel_matches_plain(cuda: torch.device, dtype: torch.dtype) -> None:
    """K6 vs its plain version, scale as a column chunk: dx within 1e-4 (f32) or one bf16 ulp
    (2**-7) of its largest value, the f32 sums over tokens within 1e-4 of theirs; and the same
    bits on a second run (no atomics)."""
    gen = torch.Generator(cuda).manual_seed(7)
    x = (torch.randn((2, 250, 768), generator=gen, device=cuda) * 2 + 0.3).to(dtype)  # 250: a ragged last block
    g = torch.randn((2, 250, 768), generator=gen, device=cuda).to(dtype)
    mods = torch.randn((2, 3 * 768), generator=gen, device=cuda).to(dtype)
    scale = mods[:, 1536:]
    before = adaln.adaln_backward.launches
    got = adaln.adaln_backward(x, g, scale)
    assert adaln.adaln_backward.launches == before + 1
    ref = adaln.adaln_backward_reference(x, g, scale)
    for i, (mine, want) in enumerate(zip(got, ref)):
        rel = (1e-4 if dtype == torch.float32 else 2**-7) if i == 0 else 1e-4
        assert mine.dtype == want.dtype
        assert (mine.float() - want.float()).abs().max().item() <= rel * want.float().abs().max().item()
    for a, b in zip(got, adaln.adaln_backward(x, g, scale)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_training_kernels_refuse_what_they_cannot_take(cuda: torch.device) -> None:
    bf16 = torch.bfloat16
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention_qkv_forward_lse(torch.zeros(1, 96, 384, device=cuda, dtype=bf16), 2)
    qkv = torch.zeros(1, 128, 768, device=cuda, dtype=bf16)
    o, lse = flash_attention.flash_attention_qkv_forward_lse(qkv, 2)
    with pytest.raises(ValueError, match="g must be"):
        flash_attention.flash_attention_qkv_backward(qkv, o, lse, o[:, :64], 2)
    with pytest.raises(ValueError, match="lse must be"):
        flash_attention.flash_attention_qkv_backward(qkv, o, lse.to(bf16), o, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention_qkv_backward(qkv, o, lse, o.transpose(1, 2).contiguous().transpose(1, 2), 2)
    x = torch.zeros(1, 8, 128 * 7, device=cuda)
    with pytest.raises(ValueError, match="no kernel instance"):
        adaln.adaln_backward(x, x, x[:, 0])
    x = torch.zeros(1, 8, 128, device=cuda)
    with pytest.raises(ValueError, match="g must be"):
        adaln.adaln_backward(x, x.to(bf16), x[:, 0])
    with pytest.raises(ValueError, match="contiguous"):
        adaln.adaln_backward(x, x.transpose(1, 2).contiguous().transpose(1, 2), x[:, 0])


def _relative_fro(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


@pytest.mark.gpu
def test_autograd_functions_on_the_card(cuda: torch.device) -> None:
    """flash_attention_qkv and adaln_modulate with a gradient launch K4 + K5 and K3 + K6
    (never K2), and their gradients agree with the same Functions run through the plain
    versions to 2e-2 relative Frobenius norm (bf16)."""
    from unittest import mock

    gen = torch.Generator(cuda).manual_seed(8)
    qkv = torch.randn((2, 256, 3 * 2 * 128), generator=gen, device=cuda).to(torch.bfloat16)
    x = torch.randn((2, 256, 256), generator=gen, device=cuda).to(torch.bfloat16)
    mods = torch.randn((2, 3 * 256), generator=gen, device=cuda).to(torch.bfloat16)
    g_attn = torch.randn((2, 256, 256), generator=gen, device=cuda).to(torch.bfloat16)

    def grads() -> list[torch.Tensor]:
        q = qkv.clone().requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        m = mods.clone().requires_grad_(True)
        (flash_attention.flash_attention_qkv(q, 2).float() * g_attn.float()).sum().backward()
        (adaln.adaln_modulate(xx, m[:, :256], m[:, 512:]).float() ** 2).sum().backward()
        return [q.grad, xx.grad, m.grad]

    counts = (
        flash_attention.flash_attention_qkv_forward.launches,
        flash_attention.flash_attention_qkv_forward_lse.launches,
        flash_attention.flash_attention_qkv_backward.launches,
        adaln.adaln_forward.launches,
        adaln.adaln_backward.launches,
    )
    got = grads()
    assert flash_attention.flash_attention_qkv_forward.launches == counts[0]
    assert flash_attention.flash_attention_qkv_forward_lse.launches == counts[1] + 1
    assert flash_attention.flash_attention_qkv_backward.launches == counts[2] + 1
    assert adaln.adaln_forward.launches == counts[3] + 1
    assert adaln.adaln_backward.launches == counts[4] + 1
    with (
        mock.patch.object(flash_attention, "flash_attention_qkv_forward_lse", flash_attention._qkv_reference_lse),
        mock.patch.object(flash_attention, "flash_attention_qkv_backward", flash_attention._qkv_backward_reference),
        mock.patch.object(adaln, "adaln_forward", adaln.adaln_reference),
        mock.patch.object(adaln, "adaln_backward", adaln.adaln_backward_reference),
    ):
        want = grads()
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and _relative_fro(a, b) <= 2e-2


@pytest.mark.gpu
def test_dit_train_step_through_the_kernels(cuda: torch.device) -> None:
    """One bf16 training step of a small DiT launches K4 and K5 once per block, K3 and K6
    2*depth+1 times and K2 never; its loss agrees with the plain versions' to 1e-2 and every
    gradient to 5e-2 relative Frobenius norm (bf16 rounding at other points, over two blocks)."""
    from unittest import mock

    from skrample_tpu_torch import training
    from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree
    from skrample_tpu_torch.models.ema import ema_init

    config = DiTConfig(dim=256, depth=2, heads=2, compute_dtype=torch.bfloat16, attention="flash")
    tree = random_param_tree(config, 1)
    gen = torch.Generator(cuda).manual_seed(9)
    x0, noise, sigma = training.draw_batch(training.synthetic_dataset(32, cuda), 2, gen)

    def step(model: DiT) -> torch.Tensor:
        loss = training.flow_matching_loss(model, x0, noise, sigma)
        loss.backward()
        return loss.detach()

    kernel_model = DiT(config, device=cuda).load_jax_params(tree)
    k2 = flash_attention.flash_attention_qkv_forward.launches
    k4 = flash_attention.flash_attention_qkv_forward_lse.launches
    k5 = flash_attention.flash_attention_qkv_backward.launches
    k3, k6 = adaln.adaln_forward.launches, adaln.adaln_backward.launches
    loss = step(kernel_model)
    assert flash_attention.flash_attention_qkv_forward.launches == k2
    assert flash_attention.flash_attention_qkv_forward_lse.launches - k4 == config.depth
    assert flash_attention.flash_attention_qkv_backward.launches - k5 == config.depth
    assert adaln.adaln_forward.launches - k3 == 2 * config.depth + 1
    assert adaln.adaln_backward.launches - k6 == 2 * config.depth + 1

    plain_model = DiT(config, device=cuda).load_jax_params(tree)
    with (
        mock.patch.object(flash_attention, "flash_attention_qkv_forward_lse", flash_attention._qkv_reference_lse),
        mock.patch.object(flash_attention, "flash_attention_qkv_backward", flash_attention._qkv_backward_reference),
        mock.patch.object(adaln, "adaln_forward", adaln.adaln_reference),
        mock.patch.object(adaln, "adaln_backward", adaln.adaln_backward_reference),
    ):
        want = step(plain_model)
    assert torch.isfinite(loss) and abs(loss.item() - want.item()) <= 1e-2 * abs(want.item())
    for p, q in zip(kernel_model.parameters(), plain_model.parameters()):
        assert torch.isfinite(p.grad).all() and _relative_fro(p.grad, q.grad) <= 5e-2

    opt = training.make_optimizer(kernel_model)
    ema = ema_init(kernel_model)
    before = [p.detach().clone() for p in kernel_model.parameters()]
    training.train_step(kernel_model, opt, ema, x0, noise, sigma, step=0)
    assert any(not torch.equal(a, p) for a, p in zip(before, kernel_model.parameters()))


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [True, "dots"])
def test_dit_remat_through_the_kernels(cuda: torch.device, remat: bool | str) -> None:
    """Per-block recompute on the card re-runs K4 in the backward (twice per block and step)
    and gives the gradients of no remat to 1e-4 relative Frobenius norm: the recomputed
    bf16 values are the same bits, only the f32 accumulation of shared gradients may differ.
    Every bias gradient is an f32 sum with and without remat (ROADMAP C4, repaired)."""
    from skrample_tpu_torch import training
    from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree

    tree = random_param_tree(DiTConfig(dim=256, depth=2, heads=2), 2)
    gen = torch.Generator(cuda).manual_seed(10)
    x0, noise, sigma = training.draw_batch(training.synthetic_dataset(32, cuda), 2, gen)
    grads = []
    for mode in (False, remat):
        config = DiTConfig(dim=256, depth=2, heads=2, compute_dtype=torch.bfloat16, attention="flash", remat=mode)
        model = DiT(config, device=cuda).load_jax_params(tree)
        before = flash_attention.flash_attention_qkv_forward_lse.launches
        training.flow_matching_loss(model, x0, noise, sigma).backward()
        launched = flash_attention.flash_attention_qkv_forward_lse.launches - before
        assert launched == config.depth * (2 if mode else 1)
        grads.append({name: p.grad for name, p in model.named_parameters()})
    for name, want in grads[0].items():
        assert _relative_fro(grads[1][name], want) <= 1e-4, name


# ---- the Flux / int8 serving slice's kernels: B6, B7 ---------------------------------


def _ulps_bf16(a: torch.Tensor, b: torch.Tensor, floor: float = 0.0) -> float:
    """The largest distance between two bf16 tensors in units in the last place of the larger
    magnitude; ``floor`` (a fraction of the largest value) is the magnitude below which values
    that cancel in f32 sums count in the ulps of that floor."""
    a32, b32 = a.float(), b.float()
    scale = torch.maximum(a32.abs(), b32.abs()).clamp_min(max(2.0**-126, floor * b32.abs().max().item()))
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    return ((a32 - b32).abs() / ulp).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize(
    ("dtype", "shape"),
    [
        (torch.bfloat16, (300, 3072)),
        (torch.bfloat16, (64, 15360)),
        (torch.float32, (96, 512)),
        (torch.bfloat16, (33, 100)),  # no 16-byte vectors: the scalar loop
    ],
)
def test_quant_rows_kernel_matches_plain(cuda: torch.device, dtype: torch.dtype, shape: tuple[int, int]) -> None:
    "B6 vs its plain version: q and s bit for bit (IEEE division, ties to even), a zero row scale 1."
    gen = torch.Generator(cuda).manual_seed(11)
    x = (torch.randn(shape, generator=gen, device=cuda) * 3).to(dtype)
    x[1] = 0
    x[2, :4] = torch.tensor([127.0, 0.5, 1.5, -2.5], device=cuda).to(dtype)
    before = quant.quantize_rows.launches
    q, s = quant.quantize_rows(x)
    assert quant.quantize_rows.launches == before + 1
    want_q, want_s = quant.quantize_activation(x)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    assert s[1].item() == 1.0


@pytest.mark.gpu
def test_quant_rows_kernel_raises_on_what_it_cannot_take(cuda: torch.device) -> None:
    x = torch.zeros(8, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        quant.quantize_rows(x.t())
    with pytest.raises(ValueError, match="dtype"):
        quant.quantize_rows(x.to(torch.int32))
    with pytest.raises(ValueError, match="dtype"):
        quant.quantize_rows(x.half())


@pytest.mark.gpu
@pytest.mark.parametrize("in_place", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rope_kernel_matches_plain(cuda: torch.device, dtype: torch.dtype, in_place: bool) -> None:
    """B7 vs its plain version: bf16 within one ulp, f32 within 1e-5 relative (the sum of squares
    in another order, rsqrtf); the v third bit-equal, left alone in place and copied otherwise.
    The tables are a row view of larger ones, as a double block passes them."""
    B, N, H, d = 2, 384, 3, 128
    gen = torch.Generator(cuda).manual_seed(12)
    qkv = (torch.randn((B, N, 3 * H * d), generator=gen, device=cuda) * 2).to(dtype)
    gq = 1 + 0.2 * torch.randn(d, generator=gen, device=cuda)
    gk = 1 + 0.2 * torch.randn(d, generator=gen, device=cuda)
    angles = torch.rand((N + 64, d // 2), generator=gen, device=cuda) * 40
    cos, sin = torch.cos(angles)[64:], torch.sin(angles)[64:]
    want = rope.rope_qk_norm_reference(qkv, gq, gk, cos, sin, H)
    arg = qkv.clone()
    before = rope.rope_qk_norm_forward.launches
    got = rope.rope_qk_norm_forward(arg, gq, gk, cos, sin, H, in_place=in_place)
    assert rope.rope_qk_norm_forward.launches == before + 1
    assert (got.data_ptr() == arg.data_ptr()) == in_place
    assert torch.equal(got[..., 2 * H * d :], qkv[..., 2 * H * d :])
    if dtype == torch.bfloat16:
        assert _ulps_bf16(got, want) <= 1
    else:
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.gpu
def test_fused_rope_launches_the_kernel_at_any_n(cuda: torch.device) -> None:
    """N = 4080 (the 85x48 image tokens of a 1360x768 request: not a multiple of 128) launches B7,
    in place without a gradient and through the autograd Function with one, and matches the
    plain version within one bf16 ulp: no shape goes quietly to the plain version on the card."""
    N, H, d = 4080, 2, 128
    gen = torch.Generator(cuda).manual_seed(18)
    qkv = (torch.randn((1, N, 3 * H * d), generator=gen, device=cuda) * 2).to(torch.bfloat16)
    gq = 1 + 0.2 * torch.randn(d, generator=gen, device=cuda)
    gk = 1 + 0.2 * torch.randn(d, generator=gen, device=cuda)
    angles = torch.rand((N, d // 2), generator=gen, device=cuda) * 40
    cos, sin = torch.cos(angles), torch.sin(angles)
    want = rope.rope_qk_norm_reference(qkv, gq, gk, cos, sin, H)
    before = rope.rope_qk_norm_forward.launches
    with torch.no_grad():
        got = rope.fused_rope_qk_norm(qkv.clone(), gq, gk, cos, sin, H)
    leaf = qkv.clone().requires_grad_(True)
    out = rope.fused_rope_qk_norm(leaf, gq, gk, cos, sin, H)
    assert rope.rope_qk_norm_forward.launches == before + 2
    assert type(out.grad_fn).__name__ == "_RopeQKNormBackward"
    for result in (got, out.detach()):
        assert _ulps_bf16(result, want) <= 1
        assert torch.equal(result[..., 2 * H * d :], qkv[..., 2 * H * d :])


@pytest.mark.gpu
def test_rope_kernel_raises_on_what_it_cannot_take(cuda: torch.device) -> None:
    qkv = torch.zeros(1, 128, 3 * 2 * 64, device=cuda, dtype=torch.bfloat16)
    g = torch.ones(64, device=cuda)
    tab = torch.zeros(128, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        rope.rope_qk_norm_forward(qkv, g, g, tab, tab, 2)
    qkv = torch.zeros(1, 128, 3 * 128, device=cuda, dtype=torch.bfloat16)
    g = torch.ones(128, device=cuda)
    tab = torch.zeros(128, 64, device=cuda)
    with pytest.raises(ValueError, match="q_gain"):
        rope.rope_qk_norm_forward(qkv, g.to(torch.bfloat16), g, tab, tab, 1)
    with pytest.raises(ValueError, match="cos"):
        rope.rope_qk_norm_forward(qkv, g, g, tab[:64], tab, 1)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        rope.rope_qk_norm_forward(qkv.half(), g, g, tab, tab, 1)


@pytest.mark.gpu
def test_dense_on_the_card_rounds_once(cuda: torch.device) -> None:
    """A bf16 dense layer on the card takes the product in f32 (``aten.mm.dtype``), adds the f32 bias
    and rounds once: at least 99% of the outputs bit-equal to the same sum in f32 of the upcast
    operands rounded once (a second rounding would change a quarter of them), the rest within one
    bf16 ulp (below 1e-4 of the largest output, where two f32 sums of 512 terms in another order
    cancel, the ulp of that level)."""
    from skrample_tpu_torch.models.dit import _dense

    gen = torch.Generator(cuda).manual_seed(13)
    layer = torch.nn.Linear(512, 768, device=cuda)
    x = torch.randn((4, 64, 512), generator=gen, device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        got = _dense(layer, x, torch.bfloat16)
        w = layer.weight.to(torch.bfloat16).float()
        want = (x.float() @ w.t() + layer.bias).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and _ulps_bf16(got, want, floor=1e-4) <= 1
    assert (got == want).float().mean().item() >= 0.99


@pytest.mark.gpu
def test_dit_int8_forward_through_the_kernels(cuda: torch.device) -> None:
    """The int8 DiT launches B6 four times per block and forward, and equals the same forward
    through B6's plain version bit for bit (the kernel is bit-exact; the products are the same)."""
    from unittest import mock

    from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree

    config = DiTConfig(dim=256, depth=2, heads=2, compute_dtype=torch.bfloat16, attention="flash")
    model = DiT(config, device=cuda).load_jax_params(random_param_tree(config, 14)).quantize_params()
    x = torch.randn((2, 4, 32, 32), generator=torch.Generator(cuda).manual_seed(15), device=cuda)
    t = torch.tensor([700.0, 30.0], device=cuda)
    with torch.inference_mode():
        before = quant.quantize_rows.launches
        got = model(x, t)
        assert quant.quantize_rows.launches - before == 4 * config.depth
        with mock.patch.object(quant, "quantize_rows", quant.quantize_activation):
            want = model(x, t)
    assert torch.isfinite(got).all() and torch.equal(got, want)


@pytest.mark.gpu
def test_flux_forward_through_the_kernels(cuda: torch.device) -> None:
    """A small bf16 Flux (2 double + 2 single blocks) launches K2 once per block, K3 four times per
    double block, once per single block and once at the head, B7 twice per double block and once
    per single block; it agrees with the same forward through the plain versions to 3e-2 of its
    largest value (bf16 rounding at other points over four blocks)."""
    from unittest import mock

    from skrample_tpu_torch.models.flux import Flux, FluxConfig, random_param_tree

    config = FluxConfig(dim=256, heads=2, rope_axes=(32, 48, 48), depth=2, single_depth=2, context_dim=64, pooled_dim=32)
    model = Flux(config, device=cuda, dtype=torch.bfloat16).load_jax_params(random_param_tree(config, 16))
    gen = torch.Generator(cuda).manual_seed(17)
    x = torch.randn((2, 16, 32, 32), generator=gen, device=cuda)
    ctx = torch.randn((2, 128, 64), generator=gen, device=cuda)
    pooled = torch.randn((2, 32), generator=gen, device=cuda)
    t = torch.tensor([700.0, 30.0], device=cuda)
    wrappers = (flash_attention.flash_attention_qkv_forward, adaln.adaln_forward, rope.rope_qk_norm_forward)
    with torch.inference_mode():
        before = [fn.launches for fn in wrappers]
        got = model(x, t, ctx, pooled, guidance=3.5)
        counts = [fn.launches - b for fn, b in zip(wrappers, before)]
        assert counts == [4, 4 * 2 + 2 + 1, 2 * 2 + 2]
        with (
            mock.patch.object(flash_attention, "flash_attention_qkv_forward", flash_attention._qkv_reference),
            mock.patch.object(adaln, "adaln_forward", adaln.adaln_reference),
            mock.patch.object(rope, "rope_qk_norm_forward", lambda *a, **k: rope.rope_qk_norm_reference(*a[:6])),
        ):
            want = model(x, t, ctx, pooled, guidance=3.5)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 3e-2 * want.abs().max().item()


# ---- the SDXL slice: B8 GroupNorm and B10 d = 64 attention ---------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize(("affine", "silu"), [(True, True), (True, False), (False, True), (False, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    ("shape", "groups"),
    [((2, 1024, 320), 32), ((3, 1000, 960), 32), ((1, 77, 30), 3), ((2, 4096, 2560), 32)],
)
def test_groupnorm_kernel_matches_plain(
    cuda: torch.device, shape, groups: int, dtype: torch.dtype, affine: bool, silu: bool
) -> None:
    """B8 against the plain version on the same inputs: f32 within 1e-5 of the largest output (the
    same centered statistics merged in another order); bf16 within 2^-7 of it (one rounding each,
    an ulp apart where the f32 values straddle a boundary).  A ragged N (1000), C = 960 (groups of
    30) and C = 30 (no 16-byte vectors) included; two runs give the same bits."""
    gen = torch.Generator(cuda).manual_seed(shape[1] + shape[2])
    x = (torch.randn(shape, generator=gen, device=cuda) * 3 + 1.5).to(dtype)
    C = shape[-1]
    scale = (1 + 0.1 * torch.randn(C, generator=gen, device=cuda)) if affine else None
    bias = 0.1 * torch.randn(C, generator=gen, device=cuda) if affine else None
    before = groupnorm.groupnorm_forward.launches
    got = groupnorm.groupnorm_forward(x, groups, silu, 1e-5, scale, bias)
    again = groupnorm.groupnorm_forward(x, groups, silu, 1e-5, scale, bias)
    assert groupnorm.groupnorm_forward.launches == before + 2
    want = groupnorm.groupnorm_reference(x, groups, silu, 1e-5, scale, bias)
    rel = 1e-5 if dtype == torch.float32 else 2**-7
    assert got.dtype == dtype and torch.isfinite(got).all() and torch.equal(got, again)
    assert (got.float() - want.float()).abs().max().item() <= rel * want.float().abs().max().item()


@pytest.mark.gpu
def test_groupnorm_kernel_raises_on_what_it_cannot_take(cuda: torch.device) -> None:
    x = torch.zeros(2, 64, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="groups"):
        groupnorm.groupnorm_forward(x, 7)
    with pytest.raises(ValueError, match="dtype|float32"):
        groupnorm.groupnorm_forward(x.half(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        groupnorm.groupnorm_forward(x.transpose(0, 1), 8)
    with pytest.raises(ValueError, match="together"):
        groupnorm.groupnorm_forward(x, 8, scale=torch.ones(96, device=cuda))
    with pytest.raises(ValueError, match="scale"):
        groupnorm.groupnorm_forward(x, 8, scale=torch.ones(96, device=cuda).half(), bias=torch.zeros(96, device=cuda))


@pytest.mark.gpu
def test_groupnorm_function_on_the_card(cuda: torch.device) -> None:
    "``groupnorm_cl`` under autograd: B8 forward, gradients equal to the plain version's (same function)."
    gen = torch.Generator(cuda).manual_seed(3)
    x = torch.randn((2, 16, 16, 320), generator=gen, device=cuda).requires_grad_(True)
    scale = (1 + 0.1 * torch.randn(320, generator=gen, device=cuda)).requires_grad_(True)
    bias = (0.1 * torch.randn(320, generator=gen, device=cuda)).requires_grad_(True)
    g = torch.randn(x.shape, generator=gen, device=cuda)
    before = groupnorm.groupnorm_forward.launches
    out = groupnorm.groupnorm_cl(x, 32, True, 1e-5, scale, bias)
    grads = torch.autograd.grad(out, (x, scale, bias), g)
    assert groupnorm.groupnorm_forward.launches == before + 1
    ref = groupnorm.groupnorm_reference(x.view(2, 256, 320), 32, True, 1e-5, scale, bias).view(x.shape)
    want = torch.autograd.grad(ref, (x, scale, bias), g)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    for a, b in zip(grads, want):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-5 * b.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize(("B", "N", "heads"), [(2, 1024, 10), (1, 4096, 4), (2, 1000, 5), (1, 77, 3)])
def test_pairs_attention_kernel_matches_plain(
    cuda: torch.device, B: int, N: int, heads: int, dtype: torch.dtype
) -> None:
    """B10 on the ``chunk(3)`` views of one fused qkv tensor (row stride 3*H*64) against the plain
    attention on the same views: atol 5e-3, as K2 (probabilities round to 16 bits at other points).
    Ragged N (1000, 77: a last tile of masked keys) and odd head counts included."""
    gen = torch.Generator(cuda).manual_seed(N + heads)
    qkv = torch.randn((B, N, 3 * heads * 64), generator=gen, device=cuda).to(dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    before = flash_attention.flash_attention_pairs_forward.launches
    got = flash_attention.flash_attention_pairs_forward(q, k, v, heads)
    assert flash_attention.flash_attention_pairs_forward.launches == before + 1
    want = flash_attention._packed_reference(q, k, v, heads)
    assert got.shape == want.shape and got.is_contiguous() and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 5e-3
    # the same attention from separate contiguous tensors: the strides are honoured
    again = flash_attention.flash_attention_pairs_forward(q.contiguous(), k.contiguous(), v.contiguous(), heads)
    assert torch.equal(again, got)


@pytest.mark.gpu
def test_pairs_attention_kernel_raises_on_what_it_cannot_take(cuda: torch.device) -> None:
    q = torch.zeros(1, 128, 256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention.flash_attention_pairs_forward(q.float(), q.float(), q.float(), 4)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention_pairs_forward(q, q, q, 2)
    with pytest.raises(ValueError, match="stride"):
        flash_attention.flash_attention_pairs_forward(q, q[:, :, :], q.transpose(1, 2).contiguous().transpose(1, 2), 4)


@pytest.mark.gpu
def test_cond_unet_forward_through_the_kernels(cuda: torch.device) -> None:
    """A small bf16 CondUNet (widths (64, 128, 256), heads (1, 2, 4): head dim 64, depths (0, 1, 2))
    under CFG-like batch 2 launches B8 for every GroupNorm and B10 for every self-attention, exactly,
    and agrees with the same forward through the plain versions to 5e-2 of its largest value; a
    self-attention at head dim 32 (4 heads of a 128-wide projection) goes to the packed kernel B9."""
    from unittest import mock

    from skrample_tpu_torch.models.unet_cond import CondUNet, CondUNetConfig, random_param_tree

    config = CondUNetConfig(
        widths=(64, 128, 256), heads=(1, 2, 4), transformer_layers=(0, 1, 2), context_dim=48, pooled_dim=56
    )
    model = CondUNet(config, device=cuda, dtype=torch.bfloat16).load_jax_params(random_param_tree(config, 3))
    gen = torch.Generator(cuda).manual_seed(4)
    x = torch.randn((2, 4, 32, 32), generator=gen, device=cuda)
    args = (
        x,
        torch.tensor([700.0, 30.0], device=cuda),
        torch.randn((2, 77, 48), generator=gen, device=cuda),
        torch.randn((2, 56), generator=gen, device=cuda),
        torch.tensor([[256.0, 256.0, 0.0, 0.0, 256.0, 256.0]] * 2, device=cuda),
    )
    with torch.inference_mode():
        before = groupnorm.groupnorm_forward.launches, flash_attention.flash_attention_pairs_forward.launches
        got = model(*args)
        counts = (
            groupnorm.groupnorm_forward.launches - before[0],
            flash_attention.flash_attention_pairs_forward.launches - before[1],
        )
        # GroupNorms: 2 per resnet (6 down, 2 mid, 9 up), 1 per Transformer2D (4 down, 1 mid, 6 up), norm_out;
        # self-attentions: one per basic block (2 + 4 down, 2 mid, 6 + 3 up): SDXL base's 46 and 70 in miniature
        resnets = config.layers_per_block * 3 + 2 + (config.layers_per_block + 1) * 3
        transformers = 2 * 2 + 1 + 3 * 2
        assert counts == (2 * resnets + transformers + 1, 2 * 1 + 2 * 2 + 2 + 3 * 1 + 3 * 2)
        with (
            mock.patch.object(groupnorm, "groupnorm_forward", groupnorm.groupnorm_reference),
            mock.patch.object(flash_attention, "flash_attention_pairs_forward", flash_attention._packed_reference),
        ):
            want = model(*args)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 5e-2 * want.abs().max().item()
    before = flash_attention.flash_attention_packed_forward.launches
    qkv = torch.randn((1, 256, 3 * 128), generator=gen, device=cuda).to(torch.bfloat16)
    out = model._mha(*qkv.chunk(3, dim=-1), 4)
    assert flash_attention.flash_attention_packed_forward.launches == before + 1
    assert (out.float() - flash_attention._packed_reference(*qkv.chunk(3, dim=-1), 4).float()).abs().max() <= 5e-3


@pytest.mark.gpu
def test_conv_gives_an_item_the_same_bits_at_any_batch(cuda: torch.device) -> None:
    """The conv families' ``_conv`` at SDXL's 32x32 level (3x3, 1280 channels, where cuDNN sums in
    another order at batch 4 than at batch 2): an item's output bits do not depend on its batch,
    and the output is a contiguous NHWC tensor (channels-last, no relayout)."""
    from skrample_tpu_torch.models.unet import _Conv, _conv, _ConvSpec

    conv = _Conv(_ConvSpec(3, 1280, 1280), torch.bfloat16).to_empty(device=cuda)
    gen = torch.Generator(cuda).manual_seed(5)
    with torch.no_grad():
        conv.w.copy_(torch.randn(conv.w.shape, generator=gen, device=cuda) / 100)
        conv.b.copy_(torch.randn(conv.b.shape, generator=gen, device=cuda))
    x = torch.randn((4, 32, 32, 1280), generator=gen, device=cuda).to(torch.bfloat16)
    pair = _conv(conv, x[:2], torch.bfloat16)
    four = _conv(conv, x, torch.bfloat16)
    assert four.shape == (4, 32, 32, 1280) and four.is_contiguous()
    assert torch.equal(pair, four[:2])


# ---- B12: the norm-into-conv kernel, and the conv routes it serves ------------------------


def _b12_inputs(cuda, shape, co, dtype, norm, affine, residual, seed):
    "Inputs of a B12 call: a non-zero-mean x (the border must be zeroed after the norm), HWIO w, f32 stats."
    gen = torch.Generator(cuda).manual_seed(seed)
    N, H, W, C = shape
    x = (torch.randn(shape, generator=gen, device=cuda) * 2 + 1.5).to(dtype)
    w = (torch.randn((3, 3, C, co), generator=gen, device=cuda) / (3 * C**0.5)).to(dtype)
    b = 0.5 * torch.randn(co, generator=gen, device=cuda)
    stats = scale = bias = res = None
    if norm:
        mean = 1.5 + 0.1 * torch.randn((N, 1, C), generator=gen, device=cuda)
        inv = 0.5 + torch.rand((N, 1, C), generator=gen, device=cuda)
        stats = torch.cat([mean, inv], 1).contiguous()
    if affine:
        scale = 1 + 0.2 * torch.randn(C, generator=gen, device=cuda)
        bias = 0.2 * torch.randn(C, generator=gen, device=cuda)
    if residual:
        res = torch.randn((N, H, W, co), generator=gen, device=cuda).to(dtype)
    return x, w, b, stats, res, scale, bias


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(("norm", "affine", "residual"), [(False, False, False), (True, False, True), (True, True, True)])
@pytest.mark.parametrize(
    ("shape", "co"),
    [((2, 16, 16, 64), 128), ((1, 13, 19, 40), 72), ((2, 9, 7, 4), 130), ((1, 24, 24, 96), 3), ((3, 5, 33, 12), 20)],
)
def test_conv3x3_kernel_matches_plain(
    cuda: torch.device, shape, co: int, dtype: torch.dtype, norm: bool, affine: bool, residual: bool
) -> None:
    """B12 against its plain version on the same inputs, output and statistics: f32 within 1e-4 of the
    largest value (the same products summed in another order, a fast exp in the SiLU), bf16 within
    1e-2 (one rounding each of the normalized input and of the output, an ulp apart where the f32
    values straddle a boundary).  Ragged H*W (not a multiple of the 128-pixel tile), channel counts
    that take the scalar loads (C = 4, 12, 20, 40 in bf16), ragged Co (3, 20, 72, 130); two runs give
    the same bits, and an item alone gives the bits it gives in the batch."""
    args = _b12_inputs(cuda, shape, co, dtype, norm, affine, residual, sum(shape) + co)
    before = fused_conv.conv3x3_gn_silu_forward.launches
    out, raw = fused_conv.conv3x3_gn_silu_forward(*args)
    out2, raw2 = fused_conv.conv3x3_gn_silu_forward(*args)
    solo = [None if t is None or t.ndim < 2 else t[-1:] for t in args]
    solo[1:3] = args[1:3]
    solo[5:] = args[5:]
    out1, raw1 = fused_conv.conv3x3_gn_silu_forward(*solo)
    assert fused_conv.conv3x3_gn_silu_forward.launches == before + 3
    want, want_raw = fused_conv.conv3x3_ref(*args)
    torch.cuda.synchronize()
    rel = 1e-4 if dtype == torch.float32 else 1e-2
    assert out.shape == (*shape[:3], co) and out.dtype == dtype and torch.isfinite(out).all()
    assert (out.float() - want.float()).abs().max().item() <= rel * want.float().abs().max().item()
    for k in range(2):
        assert (raw[:, k] - want_raw[:, k]).abs().max().item() <= rel * want_raw[:, k].abs().max().item()
    assert torch.equal(out, out2) and torch.equal(raw, raw2)
    assert torch.equal(out1, out[-1:]) and torch.equal(raw1, raw[-1:])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_kernel_without_statistics_and_at_zero_gain(cuda: torch.device, dtype: torch.dtype) -> None:
    """``out_stats=False`` gives the same output without the statistics epilogue; a GroupNorm gain of 0
    (ROADMAP C2: the JAX package's folded affine gives inf/NaN there) stays finite and equals the plain
    version, whose normalized input is then the bias alone."""
    x, w, b, stats, res, scale, bias = _b12_inputs(cuda, (2, 20, 20, 64), 64, dtype, True, True, True, 7)
    out, raw = fused_conv.conv3x3_gn_silu_forward(x, w, b, stats, res, scale, bias)
    bare, none = fused_conv.conv3x3_gn_silu_forward(x, w, b, stats, res, scale, bias, out_stats=False)
    assert none is None and torch.equal(bare, out)
    zero = torch.zeros_like(scale)
    got, got_raw = fused_conv.conv3x3_gn_silu_forward(x, w, b, stats, res, zero, bias)
    want, _ = fused_conv.conv3x3_ref(x, w, b, stats, res, zero, bias)
    rel = 1e-4 if dtype == torch.float32 else 1e-2
    assert torch.isfinite(got).all() and torch.isfinite(got_raw).all()
    assert (got.float() - want.float()).abs().max().item() <= rel * want.float().abs().max().item()


@pytest.mark.gpu
def test_conv3x3_kernel_raises_on_what_it_cannot_take(cuda: torch.device) -> None:
    x = torch.zeros(1, 8, 8, 16, device=cuda)
    w = torch.zeros(3, 3, 16, 32, device=cuda)
    b = torch.zeros(32, device=cuda)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        fused_conv.conv3x3_gn_silu_forward(x.half(), w.half(), b)
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv.conv3x3_gn_silu_forward(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError, match="HWIO"):
        fused_conv.conv3x3_gn_silu_forward(x, w.to(torch.bfloat16), b)
    with pytest.raises(ValueError, match="stats"):
        fused_conv.conv3x3_gn_silu_forward(x, w, b, stats=torch.zeros(1, 2, 8, device=cuda))
    with pytest.raises(ValueError, match="together"):
        fused_conv.conv3x3_gn_silu_forward(x, w, b, scale=torch.ones(16, device=cuda), bias=torch.zeros(16, device=cuda))
    with pytest.raises(ValueError, match="residual"):
        fused_conv.conv3x3_gn_silu_forward(x, w, b, residual=torch.zeros(1, 8, 8, 16, device=cuda))


@pytest.mark.gpu
def test_conv3x3_function_on_the_card(cuda: torch.device) -> None:
    "``conv3x3_gn_silu`` under autograd: B12 forward, gradients equal to the plain version's (the same function)."
    args = list(_b12_inputs(cuda, (2, 10, 12, 32), 48, torch.float32, True, True, True, 9))
    for i in (0, 1, 2, 4, 5, 6):
        args[i] = args[i].requires_grad_(True)
    before = fused_conv.conv3x3_gn_silu_forward.launches
    out, raw = fused_conv.conv3x3_gn_silu(*args)
    gen = torch.Generator(cuda).manual_seed(10)
    g, g_raw = torch.randn(out.shape, generator=gen, device=cuda), torch.randn(raw.shape, generator=gen, device=cuda)
    wanted = [args[i] for i in (0, 1, 2, 4, 5, 6)]
    grads = torch.autograd.grad((out, raw), wanted, (g, g_raw))
    assert fused_conv.conv3x3_gn_silu_forward.launches == before + 1
    ref, ref_raw = fused_conv.conv3x3_ref(*args)
    want = torch.autograd.grad((ref, ref_raw), wanted, (g, g_raw))
    for a, b in zip(grads, want):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-4 * b.abs().max().item())


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    "Distance of two bf16 tensors in units in the last place of the larger magnitude."
    a32, b32 = a.float(), b.float()
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(a32.abs(), b32.abs()).clamp_min(2.0**-126))) - 7)
    return (a32 - b32).abs() / ulp


@pytest.mark.gpu
@pytest.mark.parametrize(
    ("k", "c_in", "c_out", "stride", "pad"),
    [(3, 640, 640, 1, "SAME"), (3, 4, 320, 1, "SAME"), (3, 320, 4, 1, "SAME"), (1, 640, 320, 1, "SAME"),
     (3, 320, 320, 2, 1), (3, 128, 128, 2, "SAME")],
)
def test_conv_rounds_once_on_the_card(cuda: torch.device, k: int, c_in: int, c_out: int, stride: int, pad) -> None:
    """ROADMAP C7: every bf16 conv of the conv families (3x3 through B12, the narrow conv_in/conv_out
    too; 1x1 as a product with an f32 result; stride 2 on exact TF32 products) against one rounding of
    the f32 sum of the same bf16 operands plus the f32 bias (cuDNN in f32, TF32 off): at most 1% of
    outputs differ, and none by more than 1 ulp among the outputs whose sum is not a cancellation
    (|sum| >= 2^-11 of the sum of |terms|, over 95% of them).  Two f32 sums of K terms in different
    orders differ by ~2^-24 K of the terms' scale: where the terms cancel to far below that, any two
    orders round apart by many bf16 ulps, so the bound there says nothing about the rounding."""
    from skrample_tpu_torch.models.unet import _Conv, _conv, _ConvSpec

    conv = _Conv(_ConvSpec(k, c_in, c_out), torch.bfloat16).to_empty(device=cuda)
    gen = torch.Generator(cuda).manual_seed(c_in + c_out + k)
    with torch.no_grad():
        conv.w.copy_(torch.randn(conv.w.shape, generator=gen, device=cuda) / (k * c_in**0.5))
        conv.b.copy_(torch.randn(conv.b.shape, generator=gen, device=cuda))
        x = torch.randn((2, 32, 32, c_in), generator=gen, device=cuda).to(torch.bfloat16)
        got = _conv(conv, x, torch.bfloat16, stride, pad)
        xin = x.permute(0, 3, 1, 2).float()
        if pad == "SAME" and stride == 2:
            xin, padding = torch.nn.functional.pad(xin, (0, 1, 0, 1)), 0
        else:
            padding = k // 2 if pad == "SAME" else pad
        w32, b32 = conv.w.float(), conv.b.float()
        with fused_conv.cudnn_tf32(False):
            exact = torch.nn.functional.conv2d(xin, w32, b32, stride, padding).permute(0, 2, 3, 1)
            terms = torch.nn.functional.conv2d(xin.abs(), w32.abs(), b32.abs(), stride, padding).permute(0, 2, 3, 1)
    ulps = _ulps(got, exact.to(torch.bfloat16))
    settled = exact.abs() >= terms / 2048
    assert got.shape == exact.shape and got.is_contiguous()
    assert (ulps > 0).float().mean().item() <= 1e-2 and ulps[settled].max().item() <= 1
    assert settled.float().mean().item() > 0.95


# ---- ragged N in K2, K4, K5 (ROADMAP C9) ------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1000, 77, 4592])
def test_qkv_kernels_take_a_ragged_n(cuda: torch.device, N: int) -> None:
    """K2, K4 and K5 at an N that is not a multiple of 64 (the last tile masked): the forward atol 5e-3
    and lse 1e-3 as at tiled N, each third of the gradient 2e-2 of its largest value; the dispatch
    ``flash_attention_qkv`` launches them on the card at that N (no plain fall-back)."""
    gen = torch.Generator(cuda).manual_seed(N)
    heads = 2
    qkv = torch.randn((2 if N < 4096 else 1, N, 3 * heads * 128), generator=gen, device=cuda).to(torch.bfloat16)
    got = flash_attention.flash_attention_qkv_forward(qkv, heads)
    ref = flash_attention._qkv_reference(qkv, heads)
    assert (got.float() - ref.float()).abs().max().item() <= 5e-3
    o, lse = flash_attention.flash_attention_qkv_forward_lse(qkv, heads)
    ref_o, ref_lse = flash_attention._qkv_reference_lse(qkv, heads)
    assert torch.equal(o, got) and (lse - ref_lse).abs().max().item() <= 1e-3
    g = torch.randn(o.shape, generator=gen, device=cuda).to(torch.bfloat16)
    dqkv = flash_attention.flash_attention_qkv_backward(qkv, o, lse, g, heads)
    want = flash_attention._qkv_backward_reference(qkv, o, lse, g, heads)
    for part, ref_part in zip(dqkv.chunk(3, -1), want.chunk(3, -1)):
        assert torch.isfinite(part).all()
        assert (part.float() - ref_part.float()).abs().max().item() <= 2e-2 * ref_part.float().abs().max().item()
    before = flash_attention.flash_attention_qkv_forward.launches
    with torch.inference_mode():
        flash_attention.flash_attention_qkv(qkv, heads)
    assert flash_attention.flash_attention_qkv_forward.launches == before + 1


# ---- the Hopper forward attention (K2, K4, B9, B10: csrc/flash_attention_sm90.cu) ----------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("mode", [0, 1])
def test_sm90_attention_primitives_one_product(cuda: torch.device, mode: int, d: int, dtype: torch.dtype) -> None:
    """One wgmma product of the Hopper body against ``torch.matmul`` in f32 on the same 16-bit inputs
    (the sums' order differs: atol/rtol 1e-3).  Mode 0: the score product from shared memory (SS, both
    K-major, d / 64 slabs of the 128-byte swizzle); mode 1: the value product with A from registers (RS)
    and B read MN-major through the transpose bit (``desc_mn_sw128``).  bf16 and the ``.f16`` form."""
    from skrample_tpu_torch.ops import _cuda

    gen = torch.Generator(cuda).manual_seed(16 * mode + d)
    a = torch.randn((64, d if mode == 0 else 128), generator=gen, device=cuda).to(dtype)
    b = torch.randn((128, d), generator=gen, device=cuda).to(dtype)
    out = torch.full((64, 128 if mode == 0 else d), float("nan"), device=cuda)
    lib = _cuda.library()
    code = lib.skt_attention_sm90_probe(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), mode, d, _cuda.DTYPE_CODES[dtype], _cuda.stream()
    )
    _cuda.check(code, "probe")
    torch.cuda.synchronize()
    want = a.float() @ (b.float().t() if mode == 0 else b.float())
    torch.testing.assert_close(out, want, atol=1e-3, rtol=1e-3)


def _sm90_views(layout: str, B: int, H: int, N: int, d: int, dtype: torch.dtype, gen) -> tuple:
    "q, k, v of one fused qkv tensor: packed qkv (K2), chunk(3) views (B9b, B10) or (B, H, N, d) views (B9a)."
    qkv = torch.randn((B, N, 3 * H * d), generator=gen, device=gen.device).to(dtype)
    if layout == "qkv":
        return (qkv,)
    q, k, v = qkv.chunk(3, dim=-1)
    if layout == "chunk":
        return q, k, v
    return tuple(part.reshape(B, N, H, d).transpose(1, 2) for part in (q, k, v))


def _sm90_call(layout: str, views: tuple, H: int, d: int) -> torch.Tensor:
    if layout == "qkv":
        return flash_attention.flash_attention_qkv_forward(views[0], H)
    if layout == "chunk":
        fn = flash_attention.flash_attention_pairs_forward if d == 64 else flash_attention.flash_attention_packed_forward
        return fn(*views, H)
    return flash_attention.flash_attention_forward(*views)


def _sm90_plain(layout: str, views: tuple, H: int) -> torch.Tensor:
    if layout == "qkv":
        return flash_attention._qkv_reference(views[0], H)
    if layout == "chunk":
        return flash_attention._packed_reference(*views, H)
    return flash_attention.attention_reference(*views)


_SM90_CASES = [
    ("qkv", 2, 2, 77, 128),
    ("qkv", 1, 3, 1000, 128),
    ("qkv", 1, 2, 4592, 128),
    ("chunk", 2, 3, 77, 64),
    ("chunk", 1, 2, 1000, 64),
    ("chunk", 1, 2, 1000, 128),
    ("chunk", 1, 2, 4592, 64),
    ("bhnd", 2, 2, 300, 64),
    ("bhnd", 1, 3, 1024, 128),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize(("layout", "B", "H", "N", "d"), _SM90_CASES)
def test_sm90_attention_matches_plain(
    cuda: torch.device, layout: str, B: int, H: int, N: int, d: int, dtype: torch.dtype
) -> None:
    """The Hopper body behind each wrapper against its plain version at ragged and tiled N, d 64 and
    128, on the packed qkv, on chunk(3) views and on (B, H, N, d) views, every launch counted on the
    wgmma route.  Tolerance: atol 5e-3, or one ulp of the largest output where that is more (P rounds to
    16 bits before its normalisation here, after it in the plain version, which moves an output by up to
    about one ulp: at N = 77 outputs reach past 1, where a bf16 ulp is 7.8e-3)."""
    gen = torch.Generator(cuda).manual_seed(N + d + H)
    views = _sm90_views(layout, B, H, N, d, dtype, gen)
    wrapper = {
        "qkv": flash_attention.flash_attention_qkv_forward,
        "chunk": flash_attention.flash_attention_pairs_forward if d == 64 else flash_attention.flash_attention_packed_forward,
        "bhnd": flash_attention.flash_attention_forward,
    }[layout]
    before = dict(wrapper.routes)
    got = _sm90_call(layout, views, H, d)
    want = _sm90_plain(layout, views, H)
    assert wrapper.routes == {"wgmma": before["wgmma"] + 1}
    assert got.shape == want.shape and torch.isfinite(got).all()
    top = want.float().abs().max().item()
    ulp = 2.0 ** (np.floor(np.log2(top)) - (7 if dtype == torch.bfloat16 else 10))
    assert (got.float() - want.float()).abs().max().item() <= max(5e-3, ulp)


@pytest.mark.gpu
@pytest.mark.parametrize("N", [77, 1000, 1024])
def test_sm90_lse_matches_plain(cuda: torch.device, N: int) -> None:
    """K4 on the Hopper body: the output equals K2's bit for bit, lse within 1e-3 of the plain
    logsumexp (natural-log units), at a ragged and a tiled N."""
    gen = torch.Generator(cuda).manual_seed(N)
    qkv = torch.randn((2, N, 3 * 3 * 128), generator=gen, device=cuda).to(torch.bfloat16)
    o, lse = flash_attention.flash_attention_qkv_forward_lse(qkv, 3)
    ref_o, ref_lse = flash_attention._qkv_reference_lse(qkv, 3)
    assert torch.equal(o, flash_attention.flash_attention_qkv_forward(qkv, 3))
    assert (o.float() - ref_o.float()).abs().max().item() <= 5e-3
    assert lse.shape == ref_lse.shape and (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize(("layout", "H", "N", "d"), [("qkv", 2, 1000, 128), ("chunk", 3, 1000, 64), ("bhnd", 2, 300, 128)])
def test_sm90_attention_batch_one_is_a_slice_of_batch_four(cuda: torch.device, layout: str, H: int, N: int, d: int) -> None:
    "An item's output alone equals its slice of a batch of 4, bit for bit (the plan never reads B); K4 too."
    gen = torch.Generator(cuda).manual_seed(7)
    views = _sm90_views(layout, 4, H, N, d, torch.bfloat16, gen)
    packed = _sm90_call(layout, views, H, d)
    alone = _sm90_call(layout, tuple(v[2:3] for v in views), H, d)
    assert torch.equal(alone, packed[2:3])
    if layout == "qkv":
        o4, lse4 = flash_attention.flash_attention_qkv_forward_lse(views[0], H)
        o1, lse1 = flash_attention.flash_attention_qkv_forward_lse(views[0][2:3], H)
        assert torch.equal(o1, o4[2:3]) and torch.equal(lse1, lse4[2:3])


@pytest.mark.gpu
@pytest.mark.parametrize(("layout", "d"), [("qkv", 128), ("chunk", 64), ("bhnd", 128)])
def test_sm90_attention_stages_do_not_change_a_bit(cuda: torch.device, layout: str, d: int) -> None:
    """The depth of the K/V ring (2, 3 and, at d = 64, 4 stages) gives the same bits: a row's sums run
    in the key tile's order alone.  At a ragged N (200), whose last block holds rows past N."""
    from unittest import mock

    gen = torch.Generator(cuda).manual_seed(3)
    views = _sm90_views(layout, 2, 2, 200, d, torch.bfloat16, gen)
    outs = []
    for stages in (2, 3, 4) if d == 64 else (2, 3):
        forced = dataclasses.replace(flash_attention.attention_plan(200, d), stages=stages)
        with mock.patch.object(flash_attention, "attention_plan", lambda N, d, forced=forced: forced):
            outs.append(_sm90_call(layout, views, 2, d))
    assert all(torch.equal(out, outs[0]) for out in outs[1:])


@pytest.mark.gpu
def test_sm90_attention_refuses_a_plan_that_does_not_fit(cuda: torch.device) -> None:
    "The C entry point checks the plan it is given: a block whose shared memory exceeds 227 KB raises."
    from unittest import mock

    qkv = torch.zeros((1, 256, 3 * 128), device=cuda, dtype=torch.bfloat16)
    plan = dataclasses.replace(flash_attention.attention_plan(256, 128), stages=8)
    with mock.patch.object(flash_attention, "attention_plan", lambda N, d: plan), pytest.raises(RuntimeError, match="CUDA error"):
        flash_attention.flash_attention_qkv_forward(qkv, 1)


# ---- the Hopper backward attention (K5: csrc/flash_attention_bwd.cu) and B11 on the forward body ----


def _k5_inputs(cuda: torch.device, B: int, N: int, H: int, dtype: torch.dtype, seed: int):
    "qkv, K4's o and lse, and an output gradient g: K5's inputs as the training step gives them."
    gen = torch.Generator(cuda).manual_seed(seed)
    qkv = torch.randn((B, N, 3 * H * 128), generator=gen, device=cuda).to(dtype)
    g = torch.randn((B, N, H * 128), generator=gen, device=cuda).to(dtype)
    o, lse = flash_attention.flash_attention_qkv_forward_lse(qkv, H)
    return qkv, o, lse, g


@pytest.mark.gpu
def test_sm90_backward_batch_one_is_a_slice_of_batch_four(cuda: torch.device) -> None:
    "An item's gradient alone equals its slice of a batch of 4, bit for bit (the plan never reads B), at N 1000."
    qkv, o, lse, g = _k5_inputs(cuda, 4, 1000, 2, torch.bfloat16, 5)
    packed = flash_attention.flash_attention_qkv_backward(qkv, o, lse, g, 2)
    alone = flash_attention.flash_attention_qkv_backward(qkv[2:3], o[2:3], lse[2:3].contiguous(), g[2:3], 2)
    assert torch.equal(alone, packed[2:3])


@pytest.mark.gpu
def test_sm90_backward_stages_do_not_change_a_bit(cuda: torch.device) -> None:
    """The depth of the dkv kernel's Q/dO ring (2, 3, 4 stages; the dq kernel's K/V ring fits only 2) gives
    the same bits: every output's sums run in the order of its tile alone.  At a ragged N (200)."""
    from unittest import mock

    qkv, o, lse, g = _k5_inputs(cuda, 2, 200, 2, torch.bfloat16, 3)
    plan = flash_attention.attention_backward_plan(200, 128)
    outs = []
    for dkv_stages in (2, 3, 4):
        forced = dataclasses.replace(plan, dkv_stages=dkv_stages)
        with mock.patch.object(flash_attention, "attention_backward_plan", lambda N, d, forced=forced: forced):
            outs.append(flash_attention.flash_attention_qkv_backward(qkv, o, lse, g, 2))
    assert all(torch.equal(out, outs[0]) for out in outs[1:])


@pytest.mark.gpu
def test_sm90_backward_refuses_a_plan_that_does_not_fit(cuda: torch.device) -> None:
    "The C entry point checks the plan it is given: a dq block whose shared memory exceeds 227 KB raises."
    from unittest import mock

    qkv, o, lse, g = _k5_inputs(cuda, 1, 256, 1, torch.bfloat16, 4)
    plan = dataclasses.replace(flash_attention.attention_backward_plan(256, 128), dq_stages=3)
    with (
        mock.patch.object(flash_attention, "attention_backward_plan", lambda N, d: plan),
        pytest.raises(RuntimeError, match="CUDA error"),
    ):
        flash_attention.flash_attention_qkv_backward(qkv, o, lse, g, 1)


# ---- B9: attention on (B, H, N, d) and on packed d = 128 heads ---------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize(("B", "H", "N", "d"), [(2, 6, 1024, 64), (1, 2, 1000, 128), (2, 3, 300, 40), (1, 2, 77, 32)])
def test_flash_attention_forward_kernel_matches_plain(
    cuda: torch.device, B: int, H: int, N: int, d: int, dtype: torch.dtype
) -> None:
    """B9a on the (B, H, N, d) views of one fused qkv tensor against the plain attention: atol 5e-3,
    as K2.  Head dims 64 and 128 read in place; 40 and 32 zero-padded to 64 with the true scale."""
    gen = torch.Generator(cuda).manual_seed(N + d)
    qkv = torch.randn((B, N, 3 * H * d), generator=gen, device=cuda).to(dtype)
    q, k, v = (part.reshape(B, N, H, d).transpose(1, 2) for part in qkv.chunk(3, dim=-1))
    before = flash_attention.flash_attention_forward.launches
    got = flash_attention.flash_attention_forward(q, k, v)
    assert flash_attention.flash_attention_forward.launches == before + 1
    want = flash_attention.attention_reference(q, k, v)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 5e-3
    again = flash_attention.flash_attention_forward(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(again, got)


@pytest.mark.gpu
@pytest.mark.parametrize(("B", "N", "heads"), [(2, 4096, 5), (1, 1000, 3)])
def test_flash_attention_packed_kernel_matches_plain(cuda: torch.device, B: int, N: int, heads: int) -> None:
    "B9b on the chunk(3) views of a fused (B, N, 3*H*128) product against the plain attention: atol 5e-3."
    gen = torch.Generator(cuda).manual_seed(N)
    q, k, v = torch.randn((B, N, 3 * heads * 128), generator=gen, device=cuda).to(torch.bfloat16).chunk(3, dim=-1)
    before = flash_attention.flash_attention_packed_forward.launches
    got = flash_attention.flash_attention_packed_forward(q, k, v, heads)
    assert flash_attention.flash_attention_packed_forward.launches == before + 1
    want = flash_attention._packed_reference(q, k, v, heads)
    assert (got.float() - want.float()).abs().max().item() <= 5e-3


@pytest.mark.gpu
def test_b9_kernels_raise_on_what_they_cannot_take(cuda: torch.device) -> None:
    x = torch.zeros(1, 2, 128, 136, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention_forward(x, x, x)
    x = torch.zeros(1, 2, 128, 60, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention_forward(x, x, x)
    x = torch.zeros(1, 2, 128, 64, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention.flash_attention_forward(x, x, x)
    q = torch.zeros(1, 128, 512, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim must be 128"):
        flash_attention.flash_attention_packed_forward(q, q, q, 8)


@pytest.mark.gpu
def test_dit_at_head_dim_64_through_b9(cuda: torch.device) -> None:
    """A bf16 DiT-256/2 at 4 heads of 64 with ``attention="flash"`` launches B9a once a block, and agrees
    with the same forward through the plain versions to 3e-2 of its largest value."""
    from unittest import mock

    from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree

    config = DiTConfig(dim=256, depth=2, heads=4, compute_dtype=torch.bfloat16, attention="flash")
    model = DiT(config, device=cuda).load_jax_params(random_param_tree(config, 0))
    x = torch.randn((2, 4, 32, 32), generator=torch.Generator(cuda).manual_seed(4), device=cuda)
    before = flash_attention.flash_attention_forward.launches
    with torch.inference_mode():
        got = model(x, 500.0)
        assert flash_attention.flash_attention_forward.launches - before == config.depth
        with (
            mock.patch.object(flash_attention, "flash_attention_forward", flash_attention.attention_reference),
            mock.patch.object(adaln, "adaln_forward", adaln.adaln_reference),
        ):
            want = model(x, 500.0)
    assert torch.isfinite(got).all() and (got - want).abs().max().item() <= 3e-2 * want.abs().max().item()


@pytest.mark.gpu
def test_cond_unet_packed_route_launches_b9(cuda: torch.device) -> None:
    "The CondUNet's self-attention at head dim 32 (padded to 128) launches B9b once: atol 5e-3 vs plain."
    from skrample_tpu_torch.models.unet_cond import CondUNet

    gen = torch.Generator(cuda).manual_seed(32)
    q, k, v = torch.randn((2, 1000, 3 * 4 * 32), generator=gen, device=cuda).to(torch.bfloat16).chunk(3, dim=-1)
    before = flash_attention.flash_attention_packed_forward.launches
    got = CondUNet._mha(None, q, k, v, 4)
    assert flash_attention.flash_attention_packed_forward.launches == before + 1
    want = flash_attention._packed_reference(q, k, v, 4)
    assert (got.float() - want.float()).abs().max().item() <= 5e-3


_B12_VARIANTS = (  # (norm, affine, residual, statistics, zero gain)
    (False, False, False, False, False),
    (True, False, True, True, False),
    (True, True, True, True, False),
    (True, True, False, True, True),
)


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 7, 64, 130])
@pytest.mark.parametrize("C", [4, 16, 64, 320])
@pytest.mark.parametrize("co", [3, 4, 64, 320, 640])
def test_conv3x3_routes_match_plain(cuda: torch.device, co: int, C: int, W: int) -> None:
    """B12 bf16 on both of its routes against the plain version: the wgmma kernel (C % 8 == 0: halo,
    shifted descriptors, BN from Co) and the mma.sync kernel (C = 4, the explicit route), over
    Co in {3, 4, 64, 320, 640}, C in {4, 16, 64, 320}, W in {1, 7, 64, 130} at H = 5 (H * W never a
    whole number of tiles), the variants cycling through bare, norm + residual + statistics, with the
    affine, and gain 0 without the residual.  Output within 1e-2 of the largest value, statistics 1e-2
    relative; the route counted; the same bits twice; item 1 alone equals item 1 packed at N = 3."""
    variant = _B12_VARIANTS[(co + C + W) % len(_B12_VARIANTS)]
    norm, affine, residual, with_stats, zero_gain = variant
    args = list(_b12_inputs(cuda, (3, 5, W, C), co, torch.bfloat16, norm, affine, residual, co * 7 + C + W))
    if zero_gain:
        args[5] = torch.zeros_like(args[5])
    route = "wgmma" if C % 8 == 0 else "mma_sync"
    assert fused_conv.conv3x3_plan(5, W, C, co).route == route
    before = fused_conv.conv3x3_gn_silu_forward.routes[route]
    out, raw = fused_conv.conv3x3_gn_silu_forward(*args, out_stats=with_stats)
    again, again_raw = fused_conv.conv3x3_gn_silu_forward(*args, out_stats=with_stats)
    solo = [t if t is None or t.ndim < 2 or i in (1, 2) else t[1:2] for i, t in enumerate(args)]
    solo[5:] = args[5:]
    alone, alone_raw = fused_conv.conv3x3_gn_silu_forward(*solo, out_stats=with_stats)
    assert fused_conv.conv3x3_gn_silu_forward.routes[route] == before + 3
    want, want_raw = fused_conv.conv3x3_ref(*args)
    torch.cuda.synchronize()
    assert out.shape == (3, 5, W, co) and torch.isfinite(out).all()
    assert (out.float() - want.float()).abs().max().item() <= 1e-2 * want.float().abs().max().item()
    assert torch.equal(out, again) and torch.equal(alone, out[1:2])
    if with_stats:
        for k in range(2):
            assert (raw[:, k] - want_raw[:, k]).abs().max().item() <= 1e-2 * want_raw[:, k].abs().max().item()
        assert torch.equal(raw, again_raw) and torch.equal(alone_raw, raw[1:2])
    else:
        assert raw is None


@pytest.mark.gpu
def test_conv3x3_wgmma_one_tile_and_the_video_shapes(cuda: torch.device) -> None:
    """The wgmma route on one tile (a 4x4 image: every tap's shifted view starts at a different row of
    the swizzle pattern) and at the video decode's finest-level shapes cut to 2 frames of 64x96 (Co 64
    with the norm, residual and statistics; Co 3, bare): output within 1e-2, statistics 1e-2."""
    for shape, co, norm in (((1, 4, 4, 64), 64, True), ((2, 64, 96, 64), 64, True), ((2, 64, 96, 64), 3, False)):
        args = _b12_inputs(cuda, shape, co, torch.bfloat16, norm, False, norm, sum(shape) + co)
        out, raw = fused_conv.conv3x3_gn_silu_forward(*args)
        want, want_raw = fused_conv.conv3x3_ref(*args)
        torch.cuda.synchronize()
        assert (out.float() - want.float()).abs().max().item() <= 1e-2 * want.float().abs().max().item()
        assert (raw - want_raw).abs().max().item() <= 1e-2 * want_raw.abs().max().item()


# ---- B13: the causal temporal conv --------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize(
    ("mode", "S", "C", "Co"), [("stats", 300, 64, 72), ("residual", 4096, 40, 40), ("repeat", 200, 128, 128)]
)
def test_tconv_kernel_matches_plain(cuda: torch.device, mode: str, S: int, C: int, Co: int) -> None:
    """B13 against its plain version, bf16, in the three forms of the fused video decode, at ragged
    site counts and a channel count off the vector width: out within 1e-2 of the largest value (one
    bf16 rounding of f32 sums in another order), statistics 1e-2 relative; the same bits twice; an item
    alone gives its packed bits."""
    gen = torch.Generator(cuda).manual_seed(S + C)
    B, T, rep = 2, 4, 2 if mode == "repeat" else 1
    x = (torch.randn((B, T, S, C), generator=gen, device=cuda) * 2 + 0.5).to(torch.bfloat16)
    w = torch.randn((3, C, Co), generator=gen, device=cuda) / (3 * C) ** 0.5
    b = 0.1 * torch.randn(Co, generator=gen, device=cuda)
    stats = residual = None
    if mode != "repeat":
        raw = fused_conv.channel_stats(x.reshape(B * T, S, C))
        stats = fused_conv.finalize_group_stats(raw, 8, S).reshape(B, T, 2, C)
    if mode == "residual":
        residual = torch.randn((B, T, S, Co), generator=gen, device=cuda).to(torch.bfloat16)
    before = fused_conv.tconv_causal_gn_silu_forward.launches
    got, raw = fused_conv.tconv_causal_gn_silu_forward(x, w, b, stats, residual, rep)
    assert fused_conv.tconv_causal_gn_silu_forward.launches == before + 1
    want, want_raw = fused_conv.tconv_causal_ref(x, w, b, stats, residual, rep)
    assert got.shape == (B, T * rep, S, Co) and raw.shape == (B, T * rep, 2, Co)
    assert (got.float() - want.float()).abs().max().item() <= 1e-2 * want.float().abs().max().item()
    assert (raw - want_raw).abs().max().item() <= 1e-2 * want_raw.abs().max().item()
    again, again_raw = fused_conv.tconv_causal_gn_silu_forward(x, w, b, stats, residual, rep)
    assert torch.equal(again, got) and torch.equal(again_raw, raw)
    alone, alone_raw = fused_conv.tconv_causal_gn_silu_forward(
        x[1:], w, b, None if stats is None else stats[1:], None if residual is None else residual[1:], rep
    )
    assert torch.equal(alone, got[1:]) and torch.equal(alone_raw, raw[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 2, 5, 16])
@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("Co", [64, 128, 256])
def test_tconv_frame_walk_matches_plain(cuda: torch.device, T: int, rep: int, Co: int) -> None:
    """B13's wgmma frame walk against the plain version at T in {1, 2, 5, 16} (T < k included), rep 1
    (the norm on, a residual at Co 64 and 256) and 2 (the frame repeat, no norm), Co in {64, 128, 256},
    S = 333 sites (no whole number of tiles), C = 64 or 128: out within 1e-2 of the largest value,
    statistics 1e-2 relative, the same bits twice, item 1 alone equal to item 1 packed."""
    S, C, B = 333, 64 if Co != 128 else 128, 2
    gen = torch.Generator(cuda).manual_seed(T * 1000 + rep * 100 + Co)
    x = (torch.randn((B, T, S, C), generator=gen, device=cuda) * 2 + 0.5).to(torch.bfloat16)
    w = torch.randn((3, C, Co), generator=gen, device=cuda) / (3 * C) ** 0.5
    b = 0.1 * torch.randn(Co, generator=gen, device=cuda)
    stats = residual = None
    if rep == 1:
        raw_in = fused_conv.channel_stats(x.reshape(B * T, S, C))
        stats = fused_conv.finalize_group_stats(raw_in, 8, S).reshape(B, T, 2, C)
        if Co != 128:
            residual = torch.randn((B, T, S, Co), generator=gen, device=cuda).to(torch.bfloat16)
    assert fused_conv.tconv_plan(T, S, C, Co, 3, rep).route == "wgmma"
    before = fused_conv.tconv_causal_gn_silu_forward.routes["wgmma"]
    got, raw = fused_conv.tconv_causal_gn_silu_forward(x, w, b, stats, residual, rep)
    again, again_raw = fused_conv.tconv_causal_gn_silu_forward(x, w, b, stats, residual, rep)
    alone, alone_raw = fused_conv.tconv_causal_gn_silu_forward(
        x[1:], w, b, None if stats is None else stats[1:], None if residual is None else residual[1:], rep
    )
    assert fused_conv.tconv_causal_gn_silu_forward.routes["wgmma"] == before + 3
    want, want_raw = fused_conv.tconv_causal_ref(x, w, b, stats, residual, rep)
    torch.cuda.synchronize()
    assert got.shape == (B, T * rep, S, Co) and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 1e-2 * want.float().abs().max().item()
    assert (raw - want_raw).abs().max().item() <= 1e-2 * want_raw.abs().max().item()
    assert torch.equal(again, got) and torch.equal(again_raw, raw)
    assert torch.equal(alone, got[1:]) and torch.equal(alone_raw, raw[1:])


@pytest.mark.gpu
def test_tconv_kernel_raises_on_what_it_cannot_take(cuda: torch.device) -> None:
    x = torch.zeros(1, 2, 64, 16, device=cuda)
    w = torch.zeros(3, 16, 16, device=cuda)
    b = torch.zeros(16, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_conv.tconv_causal_gn_silu_forward(x, w, b)
    x = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="repeat_in"):
        fused_conv.tconv_causal_gn_silu_forward(x, w, b, torch.zeros(1, 2, 2, 16, device=cuda), None, 2)
    with pytest.raises(ValueError, match="residual"):
        fused_conv.tconv_causal_gn_silu_forward(x, w, b, None, torch.zeros(1, 2, 64, 8, device=cuda, dtype=torch.bfloat16))


@pytest.mark.gpu
def test_video_vae_fused_decode_through_the_kernels(cuda: torch.device) -> None:
    """A small bf16 VideoVAE's fused decode runs B12 and B13 as its tree counts them (B12 twice more: the
    bare bf16 in_conv and out_conv, norm off, through ``_conv``), and agrees with its unfused decode and
    with the fused decode through the plain versions to 5e-2 relative (Frobenius): bf16 activations
    rounded at other points."""
    import dataclasses
    from unittest import mock

    from skrample_tpu_torch.models.video_vae import VideoVAE, VideoVAEConfig, fused_convs_per_decode

    config = VideoVAEConfig(base=32, levels=3, temporal_levels=2, groups=8, fused_decode=True)
    gen = torch.Generator(cuda).manual_seed(3)
    vae = VideoVAE(config, device=cuda, generator=gen)
    vae.reset_parameters(gen, noise=0.02)
    z = torch.randn((1, 16, 2, 16, 16), generator=gen, device=cuda)
    counts = (fused_conv.conv3x3_gn_silu_forward.launches, fused_conv.tconv_causal_gn_silu_forward.launches)
    with torch.inference_mode():
        got = vae.decode(z)
        launched = (
            fused_conv.conv3x3_gn_silu_forward.launches - counts[0],
            fused_conv.tconv_causal_gn_silu_forward.launches - counts[1],
        )
        b12, b13 = fused_convs_per_decode(config)
        assert launched == (b12 + 2, b13)
        vae.config = dataclasses.replace(config, fused_decode=False)
        unfused = vae.decode(z)
        vae.config = config
        with (
            mock.patch.object(fused_conv, "conv3x3_gn_silu_forward", _plain_conv3x3),
            mock.patch.object(fused_conv, "tconv_causal_gn_silu_forward", _plain_tconv),
        ):
            plain = vae.decode(z)
    assert got.shape == (1, 3, 8, 64, 64) and torch.isfinite(got).all()
    assert _relative_fro(got, unfused) <= 5e-2 and _relative_fro(got, plain) <= 5e-2


def _plain_conv3x3(x, w, b, stats=None, residual=None, scale=None, bias=None, out_stats=True):
    out, raw = fused_conv.conv3x3_ref(x, w, b, stats, residual, scale, bias)
    return out, (raw if out_stats else None)


def _plain_tconv(x, w, b, stats=None, residual=None, repeat_in=1, out_stats=True):
    out, raw = fused_conv.tconv_causal_ref(x, w, b, stats, residual, repeat_in)
    return out, (raw if out_stats else None)


@pytest.mark.gpu
def test_video_dit_forward_through_the_kernels(cuda: torch.device) -> None:
    """A bf16 VideoDiT (dim 256 over 2 heads of 128, depth 2, 4 frames of 16x16) launches K2 once a
    block (frames folded into its batch) and K3 3 a block + 1, and agrees with the plain versions to
    3e-2 of its largest value."""
    from unittest import mock

    from skrample_tpu_torch.models.video_dit import VideoDiT, VideoDiTConfig, random_param_tree

    config = VideoDiTConfig(dim=256, depth=2, heads=2)
    model = VideoDiT(config, device=cuda).load_jax_params(random_param_tree(config, 0))
    x = torch.randn((1, 16, 4, 16, 16), generator=torch.Generator(cuda).manual_seed(4), device=cuda)
    k2, k3 = flash_attention.flash_attention_qkv_forward.launches, adaln.adaln_forward.launches
    with torch.inference_mode():
        got = model(x, 500.0)
        assert flash_attention.flash_attention_qkv_forward.launches - k2 == config.depth
        assert adaln.adaln_forward.launches - k3 == 3 * config.depth + 1
        with (
            mock.patch.object(flash_attention, "flash_attention_qkv_forward", flash_attention._qkv_reference),
            mock.patch.object(adaln, "adaln_forward", adaln.adaln_reference),
        ):
            want = model(x, 500.0)
    assert torch.isfinite(got).all() and (got - want).abs().max().item() <= 3e-2 * want.abs().max().item()


@pytest.mark.gpu
def test_threefry_draws_on_the_card_equal_the_cpu(cuda: torch.device) -> None:
    "The threefry bits and uniforms on the card are the CPU's, bit for bit; normals within 1e-5."
    from skrample_tpu_torch import prng

    key = prng.split(prng.PRNGKey(1234))[0]
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(prng.random_bits(key, (3, 1000), 32, cuda).cpu(), prng.random_bits(key, (3, 1000), 32))
        assert torch.equal(prng.uniform(key, (3, 1000), dtype, -1.0, 1.0, cuda).cpu(), prng.uniform(key, (3, 1000), dtype, -1.0, 1.0))
        card, host = prng.normal(key, (3, 1000), dtype, cuda).cpu().float(), prng.normal(key, (3, 1000), dtype).float()
        assert (card - host).abs().max().item() <= (1e-5 if dtype == torch.float32 else 2**-7 * host.abs().max().item())


# ---- B11: one K/V block's attention and row statistics (a ring attention hop) ----------


def _block_stats_inputs(cuda: torch.device, B: int, H: int, Nq: int, Nk: int, d: int, dtype: torch.dtype):
    "q as the (B, H, Nq, d) view of a fused qkv's first third, k and v views of a fused (B, Nk, 2*H*d) kv."
    gen = torch.Generator(cuda).manual_seed(Nq * 7 + Nk + d)
    q = torch.randn((B, Nq, 3 * H * d), generator=gen, device=cuda).to(dtype)[..., : H * d]
    kv = torch.randn((B, Nk, 2 * H * d), generator=gen, device=cuda).to(dtype)
    heads = lambda t, n: t.reshape(B, n, H, d).transpose(1, 2)  # noqa: E731
    return heads(q, Nq), *(heads(t, Nk) for t in kv.chunk(2, dim=-1))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize(
    ("B", "H", "Nq", "Nk", "d"),
    [
        (4, 4, 256, 256, 128),
        (1, 24, 1152, 1152, 128),
        (2, 3, 1152, 1152, 64),
        (2, 3, 40, 24, 64),
        (2, 3, 40, 24, 128),
        (2, 6, 1024, 1024, 64),
        (2, 3, 100, 300, 64),
        (2, 3, 100, 300, 128),
        (2, 3, 100, 300, 80),
    ],
)
def test_block_stats_kernel_matches_plain(
    cuda: torch.device, B: int, H: int, Nq: int, Nk: int, d: int, dtype: torch.dtype
) -> None:
    """B11 on strided q, k, v views against its plain version: o within 5e-3 plus one bf16 ulp of
    the plain value (the kernel normalises after the value product, the plain version before: at
    24 keys outputs reach 1-2, where one rounding is 2**-7), m and l within 1e-3 of their largest
    value.  A ring hop's shapes, Flux's ragged 1152-row joint block, Nq != Nk on both sides of a
    tile (the Q map's rows are Nq, the K/V maps' Nk, the key mask at Nk), head dims 64 and 128 in
    place and 80 zero-padded to 128; the launch counts on the wgmma route (the Hopper body)."""
    q, k, v = _block_stats_inputs(cuda, B, H, Nq, Nk, d, dtype)
    wrapper = flash_attention.flash_attention_block_stats
    before = wrapper.launches, dict(wrapper.routes)
    o, m, l = wrapper(q, k, v)
    assert wrapper.launches == before[0] + 1 and wrapper.routes == {"wgmma": before[1]["wgmma"] + 1}
    ro, rm, rl = flash_attention._block_stats_reference(q, k, v)
    assert o.shape == (B, H, Nq, d) and o.dtype == dtype and torch.isfinite(o).all()
    assert m.shape == l.shape == (B, H, Nq) and m.dtype == l.dtype == torch.float32
    assert m.is_contiguous() and l.is_contiguous()
    assert ((o.float() - ro.float()).abs() <= 5e-3 + 2**-8 * ro.float().abs()).all()
    for got, want in ((m, rm), (l, rl)):
        assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item()
    again = flash_attention.flash_attention_block_stats(q.contiguous(), k.contiguous(), v.contiguous())
    assert all(torch.equal(a, b) for a, b in zip(again, (o, m, l)))


@pytest.mark.gpu
def test_block_stats_m_is_in_natural_log_units(cuda: torch.device) -> None:
    """At a large score scale (inputs x 6: scaled scores in the hundreds) m is the row max of
    ``q kᵀ / sqrt(d)`` itself: a max kept in log2 units and not converted would be 1.44x off.
    m within 1e-3 of its largest value, l relative 1e-3 (at least 1: the max's own term)."""
    q, k, v = _block_stats_inputs(cuda, 2, 4, 256, 192, 128, torch.bfloat16)
    q, k = q * 6, k * 6
    o, m, l = flash_attention.flash_attention_block_stats(q, k, v)
    ro, rm, rl = flash_attention._block_stats_reference(q, k, v)
    assert rm.abs().max().item() > 100
    assert (m - rm).abs().max().item() <= 1e-3 * rm.abs().max().item()
    assert (l >= 1).all() and ((l - rl).abs() / rl).max().item() <= 1e-3
    assert (o.float() - ro.float()).abs().max().item() <= 5e-2


@pytest.mark.gpu
def test_block_stats_kernel_raises_on_what_it_cannot_take(cuda: torch.device) -> None:
    bf16 = torch.bfloat16
    x = torch.zeros(1, 2, 64, 64, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention.flash_attention_block_stats(x, x, x)
    q = torch.zeros(1, 2, 64, 64, device=cuda, dtype=bf16)
    kv = torch.zeros(1, 2, 96, 64, device=cuda, dtype=bf16)
    with pytest.raises(ValueError, match="v must be"):
        flash_attention.flash_attention_block_stats(q, kv, kv[:, :, :64])
    with pytest.raises(ValueError, match="k must be"):
        flash_attention.flash_attention_block_stats(q, torch.zeros(2, 2, 96, 64, device=cuda, dtype=bf16), kv)
    with pytest.raises(ValueError, match="head dim"):
        wide = torch.zeros(1, 2, 64, 136, device=cuda, dtype=bf16)
        flash_attention.flash_attention_block_stats(wide, wide, wide)
    with pytest.raises(ValueError, match="k must be"):
        flash_attention.flash_attention_block_stats(q, torch.zeros(1, 2, 96, 32, device=cuda, dtype=bf16), kv)


@pytest.mark.gpu
def test_sequence_parallel_sample_on_one_card(cuda: torch.device, tmp_path) -> None:
    """The dry run's 8-step samples on a one-rank NCCL group (bf16): the ring DiT (B11 every hop)
    and the ulysses DiT (B9) within 5e-2 of the flash DiT's sample, relative to its largest value."""
    from skrample_tpu_torch.parallel.dryrun import sample_cases, spawn_sp

    flash, ring, ulysses = spawn_sp(1, sample_cases("bfloat16"), str(tmp_path), "nccl", "cuda")[0]
    for got in (ring, ulysses):
        assert np.isfinite(got).all() and np.abs(got - flash).max() <= 5e-2 * np.abs(flash).max()
