"""The port's ``GenerationPipeline``, ``build_pipeline``, ``CompiledDenoiser.run(key=)`` and
``SDXLStack.pipeline`` against the JAX package's, on the CPU.

A request seeds itself as the JAX pipeline does (``split(key)`` into the
initial-latent key and the in-loop key, threefry bits equal in both
packages), so the same int seed must give the same latent: atol 1e-4 (f32
normals differ by erfinv's few ulps; the models' f32 rounding adds to it).
Most cases run an analytic elementwise model, which compiles in a moment
on the JAX side; one runs a 2-layer DiT (random weights carried across by
``load_jax_params``) and one a tiny SDXL UNet with guidance.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skrample_tpu import noise as jnoise
from skrample_tpu import pipeline as jpipe
from skrample_tpu import scheduling as jsched
from skrample_tpu.models import dit as jdit
from skrample_tpu.models import sdxl as jsdxl
from skrample_tpu.models import unet_cond as juc
from skrample_tpu.ops import CompiledDenoiser as JaxDenoiser
from skrample_tpu.ops import compile_sampler as jax_compile
from skrample_tpu.sampling import models as jmodels
from skrample_tpu.sampling import rk_solvers as jrk
from skrample_tpu.sampling import structured as jstruct
from skrample_tpu_torch import noise as tnoise
from skrample_tpu_torch import pipeline as tpipe
from skrample_tpu_torch import prng
from skrample_tpu_torch import scheduling as tsched
from skrample_tpu_torch.models import sdxl as tsdxl
from skrample_tpu_torch.models import unet_cond as tuc
from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree
from skrample_tpu_torch.ops import CompiledDenoiser, compile_sampler
from skrample_tpu_torch.sampling import models as tmodels
from skrample_tpu_torch.sampling import rk_solvers as trk
from skrample_tpu_torch.sampling import structured as tstruct

LATENT = (1, 4, 8, 8)
STEPS = 4
ATOL = 1e-4


def _analytic(x, t, s, a):
    "Elementwise in ``+ - * /``: a JAX scan of it compiles in a moment."
    return x * (0.8 * a) + (x * x) / (1 + x * x) * (0.1 * s) + 1e-4 * t


def _uncond(x, t, s, a):
    return x * (0.5 * a) - 0.05 * s


def _pipelines(case: str, model=(_analytic, _analytic), uncond=(_uncond, _uncond), steps: int = STEPS):
    """The JAX pipeline and the port's for one case, from the same configuration.  Two cases come from
    ``build_pipeline``: "deterministic" (flow=False: DPM++2M over Karras(Scaled), NoiseModel) and
    "stochastic" (flow=True: FlowShift(Linear), FlowModel, stochasticity 0.3, in-loop key noise)."""
    out = []
    for pkg, sched, mods, struct, noise, fn, ufn, extra in (
        (jpipe, jsched, jmodels, jstruct, jnoise, model[0], uncond[0], {"donate": False}),
        (tpipe, tsched, tmodels, tstruct, tnoise, model[1], uncond[1], {"device": "cpu"}),
    ):
        if case in ("deterministic", "stochastic"):
            flow = case == "stochastic"
            extra = {} if pkg is jpipe else extra  # the JAX builder donates the x0 it draws itself
            built = pkg.build_pipeline(fn, LATENT, steps=steps, flow=flow, stochasticity=0.3 * flow, **extra)
            out.append(built)
            continue
        kwargs: dict = {}
        if case == "brownian":
            gen_kw = {} if pkg is jpipe else {"device": "cpu"}
            kwargs["noise_generator"] = noise.Brownian.from_inputs(LATENT, 17, noise.BrownianProps(), **gen_kw)
        if case == "cfg":
            kwargs.update(uncond_model_fn=ufn, guidance_scale=3.0)
        sampler = struct.DPM(order=2, stochasticity=0.0 if case == "cfg" else 0.3)
        out.append(
            pkg.GenerationPipeline(
                fn, sampler, sched.FlowShift(sched.Linear()), mods.FlowModel(), steps, LATENT, **kwargs, **extra
            )
        )
    return out


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", ["deterministic", "stochastic", "brownian", "img2img", "cfg"])
def test_pipeline_matches_jax(case: str) -> None:
    """One request from int seed 5 through both pipelines: ``build_pipeline(flow=False)``, deterministic;
    ``build_pipeline(flow=True, stochasticity=0.3)``, in-loop key noise; then DPM++2M over FlowShift(Linear)
    with Brownian structured noise, img2img at strength 0.6 (enters at step 2 of 4), and CFG at 3.0 through
    ``uncond_model_fn``."""
    jp, tp = _pipelines(case)
    assert type(tp.schedule).__name__ == type(jp.schedule).__name__ and tp.nfe == jp.nfe == STEPS
    assert type(tp.model_transform).__name__ == type(jp.model_transform).__name__
    initial = np.random.default_rng(3).standard_normal(LATENT, dtype=np.float32)
    if case == "img2img":
        want = jp.generate(jax.random.PRNGKey(5), jnp.asarray(initial), strength=0.6)
        got = tp.generate(5, torch.from_numpy(initial), strength=0.6)
        assert sorted(tp._denoisers) == [0, 2]
    else:
        want, got = jp.generate(jax.random.PRNGKey(5)), tp.generate(5)
    _close(got, want)
    assert torch.equal(tp.generate(prng.PRNGKey(5), **({"initial": torch.from_numpy(initial), "strength": 0.6}
                                                         if case == "img2img" else {})), got)
    if case != "deterministic":  # the noise, the entry point or the guidance moved the result
        plain = tpipe.GenerationPipeline(
            _analytic, tstruct.DPM(order=2), tsched.FlowShift(tsched.Linear()), tmodels.FlowModel(), STEPS, LATENT,
            device="cpu",
        )
        assert (plain.generate(5) - got).abs().max() > 1e-2


def test_pipeline_dit_matches_jax() -> None:
    "A 2-layer DiT (dim 128, one head of 128, 16 tokens), 2 steps of stochastic DPM++2M with in-loop key noise."
    small = {"dim": 128, "depth": 2, "heads": 1}
    config = DiTConfig(**small, compute_dtype=torch.float32, attention="flash")
    tree = random_param_tree(config, 0)
    port = DiT(config, device="cpu").load_jax_params(tree).requires_grad_(False)
    ref = jdit.DiT(jdit.DiTConfig(**small, compute_dtype=jnp.float32, attention="flash"))
    models = (ref.as_sampleable(jax.tree.map(jnp.asarray, tree)), port.as_sampleable())
    jp, tp = _pipelines("stochastic", model=models, steps=2)
    _close(tp.generate(9), jp.generate(jax.random.PRNGKey(9)))


def test_denoiser_run_with_key_matches_jax() -> None:
    """``CompiledDenoiser.run(key=)`` draws step n from ``normal(split(key, steps)[n])`` as the JAX
    ``run(key=)`` does, here from step 2 of 4 (each step keyed by its absolute index)."""
    x0 = np.random.default_rng(4).standard_normal(LATENT, dtype=np.float32)

    def linear(x, t, s, a):
        return x * 0.9

    for start in (2,):
        sampler, schedule, transform = (
            jstruct.UniPC(order=2, stochasticity=0.7), jsched.FlowShift(jsched.Linear()), jmodels.FlowModel()
        )
        jden = JaxDenoiser.build(jax_compile(sampler, schedule, transform, STEPS, start=start))
        want = jden.run(linear, jnp.asarray(x0), key=jax.random.PRNGKey(21), start=start)
        compiled = compile_sampler(
            tstruct.UniPC(order=2, stochasticity=0.7), tsched.FlowShift(tsched.Linear()), tmodels.FlowModel(), STEPS,
            start=start,
        )
        den = CompiledDenoiser.build(compiled, device="cpu")
        got = den.run(linear, torch.from_numpy(x0), key=prng.PRNGKey(21), start=start)
        _close(got, want)
        noises = torch.stack([prng.normal(k, LATENT, device="cpu") for k in prng.split(prng.PRNGKey(21), STEPS)])
        assert torch.equal(den.run(linear, torch.from_numpy(x0), noises=noises, start=start), got)
    with pytest.raises(ValueError, match="key="):
        den.run(linear, torch.from_numpy(x0))


def test_sdxl_stack_pipeline_matches_jax() -> None:
    """``SDXLStack.pipeline`` on a tiny SDXL UNet (widths 64/128, one transformer layer), 64x64 pixels
    (8x8 latents through the VAE factor 8), 2 steps, CFG 4.0 with the defaulted time_ids: DPM++2M over
    Karras(Scaled) with NoiseModel, against the JAX stack's pipeline from the same seed."""
    tiny = {
        "widths": (64, 128), "heads": (1, 2), "transformer_layers": (0, 1), "layers_per_block": 1,
        "context_dim": 48, "pooled_dim": 56,
    }
    config = tuc.CondUNetConfig(**tiny, compute_dtype=torch.float32)
    tree = tuc.random_param_tree(config, 10)
    port = tuc.CondUNet(config, device="cpu").load_jax_params(tree).requires_grad_(False)
    ref = juc.CondUNet(juc.CondUNetConfig(**tiny, compute_dtype=jnp.float32))
    rng = np.random.default_rng(12)
    ctx, u_ctx = (rng.standard_normal((10, 48), dtype=np.float32) for _ in range(2))
    pooled, u_pool = (rng.standard_normal(56, dtype=np.float32) for _ in range(2))

    vae = SimpleNamespace(config=SimpleNamespace(downsample_factor=8))  # all the JAX pipeline reads of its VAE
    jstack = jsdxl.SDXLStack(ref, jax.tree.map(jnp.asarray, tree), vae, None, None, None)
    jp = jstack.pipeline(
        jnp.asarray(ctx), jnp.asarray(pooled), steps=2, guidance_scale=4.0,
        uncond=(jnp.asarray(u_ctx), jnp.asarray(u_pool)), donate=False,
    )
    stack = tsdxl.SDXLStack(port)
    tp = stack.pipeline(
        torch.from_numpy(ctx), torch.from_numpy(pooled), steps=2, guidance_scale=4.0,
        uncond=(torch.from_numpy(u_ctx), torch.from_numpy(u_pool)), device="cpu",
    )
    assert tp.latent_shape == tuple(jp.latent_shape) == LATENT
    assert type(tp.schedule.base).__name__ == "Scaled" and type(tp.model_transform).__name__ == "NoiseModel"
    _close(tp.generate(3), jp.generate(jax.random.PRNGKey(3)))
    with pytest.raises(ValueError, match="VAE factor"):
        stack.pipeline(torch.from_numpy(ctx), torch.from_numpy(pooled), height=60, device="cpu")
    with pytest.raises(ValueError, match="go together"):  # a ControlNet needs its image: test_torch_controlnet.py
        stack.pipeline(torch.from_numpy(ctx), torch.from_numpy(pooled), controlnet=object(), device="cpu")


def test_adaptive_pipeline_and_mesh_raise() -> None:
    """AdaptivePipeline builds on the CPU when asked (ops/adaptive.py, A2) and gives a finite latent with the
    accepted and trial counts; a mesh with a tensor-parallel axis is taken (the model's; data and tensor
    parallelism: tests/test_torch_parallel.py), and ``mesh_axes`` needs a process group; the card default
    without one."""
    adaptive = tpipe.AdaptivePipeline(
        _analytic, trk.RKMoire(order=3), tsched.Linear(), tmodels.FlowModel(), 4, LATENT, device="cpu"
    )
    sample, accepted, trials = adaptive.generate(5)
    assert tuple(sample.shape) == LATENT and bool(torch.isfinite(sample).all())
    assert accepted >= 1 and trials >= accepted - 1
    tp_mesh = type("TpMesh", (), {"mesh_dim_names": ("dp", "sp", "tp")})()  # what the pipeline reads of a mesh
    pipe = tpipe.GenerationPipeline(
        _analytic, tstruct.DPM(), tsched.Linear(), tmodels.FlowModel(), 4, LATENT, mesh=tp_mesh, device="cpu"
    )
    assert pipe.mesh is tp_mesh  # a tp axis is the model's; the pipeline splits dp (tests/test_torch_parallel.py)
    with pytest.raises(RuntimeError, match="initialised process group"):  # the JAX recipe: make_mesh(extra_axes=)
        tpipe.build_pipeline(_analytic, LATENT, mesh_axes={"tp": 2}, device="cpu")
    assert jrk.RKMoire(order=3) is not None  # the JAX sampler the JAX AdaptivePipeline takes
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tpipe.build_pipeline(_analytic, LATENT)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tpipe.AdaptivePipeline(_analytic, trk.RKMoire(order=3), tsched.Linear(), tmodels.FlowModel(), 4, LATENT)
