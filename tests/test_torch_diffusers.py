"""The port's diffusers scheduler wrapper against the JAX package's, on the CPU.

The JAX package's wrapper (``skrample_tpu.diffusers``) is itself PyTorch
code over the JAX package's host layer, so both wrappers run here on the
same CPU tensors, from the same numpy-seeded inputs and the same
``torch.Generator`` streams, driven as a ``DiffusionPipeline`` drives a
scheduler (``set_timesteps`` -> ``scale_model_input`` -> model -> ``step``).
The structured wrapper must agree bit for bit at f32, f64, bf16 and f16 for
every sampler listed: the port's plain chain on CPU tensors is the
reference's torch chain, and the reference's native C path (f32 and f64 on
the CPU) computes the same chain.  The RK wrappers' inside-out steps are
plain torch in both: bit for bit too.  The port's K1 step is emulated here
(its columns and weight rounding through the plain version of the kernel)
and held to the chain bit for bit; the kernel itself is held to that plain
version on the card (``tests/test_torch_kernels.py``).
"""

from __future__ import annotations

import dataclasses
import math

import discrete_oracles as oracle
import numpy as np
import pytest
import torch

from skrample_tpu import diffusers as jd
from skrample_tpu import diffusers_config as jdc
from skrample_tpu import scheduling as jsched
from skrample_tpu import torch_noise as jtn
from skrample_tpu.sampling import models as jmodels
from skrample_tpu.sampling import structured as jstruct
from skrample_tpu_torch import diffusers as td
from skrample_tpu_torch import diffusers_config as tdc
from skrample_tpu_torch import scheduling as tsched
from skrample_tpu_torch import torch_noise as ttn
from skrample_tpu_torch.ops import fused
from skrample_tpu_torch.sampling import models as tmodels
from skrample_tpu_torch.sampling import structured as tstruct

FLOW_CONFIG = {  # FLUX.1-dev's FlowMatchEulerDiscreteScheduler
    "_class_name": "FlowMatchEulerDiscreteScheduler",
    "base_image_seq_len": 256,
    "base_shift": 0.5,
    "max_image_seq_len": 4096,
    "max_shift": 1.15,
    "num_train_timesteps": 1000,
    "shift": 3.0,
    "use_dynamic_shifting": True,
}
SCALED_CONFIG = {  # SDXL base's EulerDiscreteScheduler
    "_class_name": "EulerDiscreteScheduler",
    "beta_end": 0.012,
    "beta_schedule": "scaled_linear",
    "beta_start": 0.00085,
    "clip_sample": False,
    "num_train_timesteps": 1000,
    "prediction_type": "epsilon",
    "steps_offset": 1,
    "timestep_spacing": "leading",
    "trained_betas": None,
    "use_karras_sigmas": False,
}
SHAPE = (1, 4, 8, 8)
STEPS = 8

# (name, sampler class name, props): the structured samplers the wrapper compiles, and SPC(power=2), which
# the compiler refuses (the polymorphic fallback)
SAMPLERS = [
    ("euler", "Euler", {}),
    ("dpm1", "DPM", {"order": 1}),
    ("dpm2", "DPM", {"order": 2}),
    ("dpm3", "DPM", {"order": 3}),
    ("dpm2-sde", "DPM", {"order": 2, "stochasticity": 1.0}),
    ("adams3", "Adams", {"order": 3}),
    ("unipc3", "UniPC", {"order": 3}),
    ("spc-power2", "SPC", {"power": 2.0}),
]
# wrapper dtype -> (latent dtype, compute_scale)
DTYPES = {
    "f32": (torch.float32, torch.float32),
    "f64": (torch.float64, torch.float64),
    "bf16": (torch.bfloat16, None),
    "f16": (torch.float16, None),
}


def _model(x: torch.Tensor, t) -> torch.Tensor:
    "A smooth stand-in epsilon/flow model, computed in f64 and rounded to the latent's dtype."
    return (0.8 * x.double() + math.sin(float(t) / 300.0) * 0.3).to(x.dtype)


def _wrappers(name: str, config: dict, compute_scale, **kwargs):
    "The same wrapper from both packages' ``from_diffusers_config``."
    cls, props = next((c, p) for n, c, p in SAMPLERS if n == name)
    return tuple(
        pkg.SkrampleWrapperScheduler.from_diffusers_config(
            config, sampler=getattr(struct, cls), sampler_props=props, compute_scale=compute_scale, **kwargs
        )
        for pkg, struct in ((jd, jstruct), (td, tstruct))
    )


def _drive(wrapper, x: torch.Tensor, seed: int, timesteps=None) -> torch.Tensor:
    "The loop a DiffusionPipeline runs: scale_model_input, the model, step (its generator seeded)."
    generator = torch.Generator().manual_seed(seed)
    for t in wrapper.timesteps if timesteps is None else timesteps:
        out = _model(wrapper.scale_model_input(x, t), t)
        x = wrapper.step(out, t, x, generator=generator).prev_sample
    return x


# ---- config translation --------------------------------------------------------------


def _norm(value):
    "A comparable form: classes by name, everything else by repr (the dataclasses print alike)."
    if isinstance(value, type):
        return value.__name__
    if isinstance(value, dict):
        return {k: _norm(v) for k, v in value.items()}
    if isinstance(value, list | tuple):
        return [_norm(v) for v in value]
    return repr(value)


CONFIGS = {f"class-{name}": SCALED_CONFIG | {"_class_name": name} for name in jdc.DIFFUSERS_CLASS_MAP} | {
    "flux-flow": FLOW_CONFIG,
    "sdxl-scaled": SCALED_CONFIG,
    "karras-v": SCALED_CONFIG | {"use_karras_sigmas": True, "prediction_type": "v_prediction"},
    "zsnr-sde": SCALED_CONFIG | {"rescale_betas_zero_snr": True, "algorithm_type": "sde-dpmsolver++"},
    "flow-sigmas": FLOW_CONFIG | {"_class_name": "UniPCMultistepScheduler", "use_flow_sigmas": True,
                                  "use_beta_sigmas": True, "solver_order": 3},
    "vp-flow-sigmas": SCALED_CONFIG | {"_class_name": "DPMSolverMultistepScheduler", "use_flow_sigmas": True},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_translation_matches_jax(name: str) -> None:
    """``parse_diffusers_config``, ``build_schedule_stack`` and the wrapper's ``.config``
    (``as_diffusers_config`` over ``attr_dict``): every field equal, classes compared by name."""
    config = CONFIGS[name]
    j, t = jdc.parse_diffusers_config(config), tdc.parse_diffusers_config(config)
    for field in dataclasses.fields(j):
        assert _norm(getattr(t, field.name)) == _norm(getattr(j, field.name)), field.name
    jw = jd.SkrampleWrapperScheduler.from_diffusers_config(config)
    tw = td.SkrampleWrapperScheduler.from_diffusers_config(config)
    assert repr(tw.sampler) == repr(jw.sampler) and repr(tw.schedule) == repr(jw.schedule)
    assert _norm(dict(tw.config)) == _norm(dict(jw.config)) and tw.config.num_train_timesteps == 1000
    assert _norm(tdc.as_diffusers_config(tw.sampler, tw.schedule, tw.model)) == _norm(
        jdc.as_diffusers_config(jw.sampler, jw.schedule, jw.model)
    )
    assert set(tdc.DIFFUSERS_CLASS_MAP) == set(jdc.DIFFUSERS_CLASS_MAP)
    assert _norm(tdc.DIFFUSERS_VALUE_MAP) == _norm(jdc.DIFFUSERS_VALUE_MAP)
    assert tdc.DIFFUSERS_KEY_MAP == jdc.DIFFUSERS_KEY_MAP and tdc.DEFAULT_FAKE_CONFIG == jdc.DEFAULT_FAKE_CONFIG


# ---- the structured wrapper, driven like a pipeline ---------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", [n for n, _, _ in SAMPLERS])
def test_wrapper_loop_matches_jax(name: str, dtype: str) -> None:
    """An 8-step loop over SDXL base's scheduler config from the same latent and generator seed: the
    final ``prev_sample`` bit for bit, and the schedule surface equal."""
    latent_dtype, compute_scale = DTYPES[dtype]
    jw, tw = _wrappers(name, SCALED_CONFIG, compute_scale)
    jw.set_timesteps(STEPS)
    tw.set_timesteps(STEPS, device="cpu")
    assert torch.equal(tw.timesteps, jw.timesteps) and torch.equal(tw.sigmas, jw.sigmas)
    assert tw.init_noise_sigma == jw.init_noise_sigma and tw.order == jw.order == 1
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(SHAPE)).to(latent_dtype)
    want, got = _drive(jw, x, seed=3), _drive(tw, x, seed=3)
    assert got.dtype == latent_dtype and bool(torch.isfinite(got).all())
    assert torch.equal(got, want)
    assert tw._compile_failed == jw._compile_failed == (name == "spc-power2")


@pytest.mark.parametrize("name", ["dpm2", "unipc3", "dpm2-sde"])
def test_kernel_columns_and_rounding_equal_the_chain(name: str, monkeypatch) -> None:
    """Emulates the wrapper's CUDA step on the CPU: every step's ``kernel_step`` (its columns, its weights
    rounded to the op's math type, through K1's plain version) against the chain the CPU path takes, bit
    for bit at each dtype; the (rows, K) each step hands K1 has an instance."""
    seen: list[tuple[int, int, torch.dtype]] = []

    def plain_k1(weights, basis, weight_dtype=None):
        seen.append((*np.asarray(weights).shape, basis[0].dtype))
        assert all(t.is_contiguous() for t in basis)
        return fused.fused_step(weights, basis, weight_dtype)

    monkeypatch.setattr(td, "fused_step_cuda", plain_k1)
    original = td.SkrampleWrapperScheduler._compiled_step

    def checked(self, compiled, index, sample, prediction, noise):
        rows = 1 if compiled.trivial_store else 3
        emulated = td.kernel_step(compiled.weights[index][:rows], self._basis(compiled, sample, prediction, noise))
        final, store_pred = original(self, compiled, index, sample, prediction, noise)
        assert torch.equal(emulated[0], final) and (rows == 1 or torch.equal(emulated[2], store_pred))
        return final, store_pred

    monkeypatch.setattr(td.SkrampleWrapperScheduler, "_compiled_step", checked)
    for latent_dtype, compute_scale in DTYPES.values():
        _, tw = _wrappers(name, SCALED_CONFIG, compute_scale)
        tw.set_timesteps(STEPS, device="cpu")
        x = torch.from_numpy(np.random.default_rng(8).standard_normal(SHAPE)).to(latent_dtype)
        _drive(tw, x, seed=4)
    assert len(seen) == STEPS * len(DTYPES)
    for rows, K, dtype in seen:
        assert fused.step_instance(rows, K, dtype)[0] == rows and rows in (1, 3)


def test_every_structured_sampler_has_a_k1_instance_through_the_wrapper() -> None:
    """Each structured sampler of orders 1-9 (with and without noise) through the wrapper: the (rows, K)
    of each step's K1 columns, the ring filled step by step, has an instance.  The wrapper drops the
    columns whose weights are all zero, so K stays at 11 or below (UniPC order 9 with noise)."""
    samplers = [tstruct.Euler(), tstruct.Euler(stochasticity=1.0), tstruct.SPC()]
    samplers += [tstruct.DPM(order=o, stochasticity=s) for o in (1, 2, 3) for s in (0.0, 1.0)]
    samplers += [tstruct.Adams(order=o) for o in range(1, 10)]
    samplers += [c(order=o, stochasticity=s) for c in (tstruct.UniP, tstruct.UniPC) for o in range(1, 10)
                 for s in (0.0, 1.0)]
    widest = 0
    for sampler in samplers:
        wrapper = td.SkrampleWrapperScheduler(sampler, tsched.FlowShift(tsched.Linear()), tmodels.FlowModel())
        wrapper.set_timesteps(10, device="cpu")
        compiled = wrapper._ensure_compiled(0)
        rows = 1 if compiled.trivial_store else 3
        ring: list = []
        for n in range(10):
            basis = [1, 1, *(v for age in range(compiled.history) for v in (ring[age] if age < len(ring) else
                                                                              (None,) * 3))]
            basis.append(1 if compiled.requires_noise else None)
            K = len(td.kernel_columns(compiled.weights[n][:rows], basis))
            widest = max(widest, K)
            for dtype in (torch.float32, torch.float64):
                assert fused.step_instance(rows, K, dtype)[0] == rows
            ring.insert(0, (1, 1, 1 if compiled.requires_noise else None))
    assert widest == 11


# ---- img2img, mu, state_dict, devices --------------------------------------------------


def test_img2img_begin_index_matches_jax() -> None:
    "``add_noise`` at the entry timestep, ``set_begin_index``, then the loop from there: bit for bit at f32."
    jw, tw = _wrappers("dpm2", SCALED_CONFIG, torch.float32)
    jw.set_timesteps(STEPS)
    tw.set_timesteps(STEPS, device="cpu")
    rng = np.random.default_rng(9)
    image, noise = (torch.from_numpy(rng.standard_normal(SHAPE)).float() for _ in range(2))
    begin = 3
    results = []
    for w in (jw, tw):
        x = w.add_noise(image, noise, w.timesteps[begin:begin + 1])
        w.set_begin_index(begin)
        results.append(_drive(w, x, seed=5, timesteps=w.timesteps[begin:]))
    assert torch.equal(results[1], results[0])
    assert tw.config["begin_index"] == begin


@pytest.mark.parametrize("mu", [0.5, 1.15])
def test_dynamic_shift_mu_matches_jax(mu: float) -> None:
    "FLUX.1-dev's config with ``set_timesteps(mu=)``: the FlowShift hot-swap and UniPC(order=3)'s loop bit for bit."
    jw, tw = _wrappers("unipc3", FLOW_CONFIG, torch.float32)
    jw.set_timesteps(STEPS, mu=mu)
    tw.set_timesteps(STEPS, device="cpu", mu=mu)
    assert repr(tw.schedule) == repr(jw.schedule) and f"shift={math.exp(mu)}" in repr(tw.schedule)
    assert torch.equal(tw.sigmas, jw.sigmas)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(SHAPE)).float()
    assert torch.equal(_drive(tw, x, 6), _drive(jw, x, 6))


@pytest.mark.parametrize("name", ["dpm2", "spc-power2"])
def test_state_dict_resume_matches_jax(name: str) -> None:
    """A run stopped after step 4, its ``state_dict`` loaded into a fresh wrapper, finishes bit for bit as
    the uninterrupted run and as the JAX wrapper (the ring, or the polymorphic history)."""
    jw, tw = _wrappers(name, SCALED_CONFIG, torch.float64)
    jw.set_timesteps(STEPS)
    tw.set_timesteps(STEPS, device="cpu")
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(SHAPE))
    want = _drive(jw, x, 1)
    half = _drive(tw, x, 1, timesteps=tw.timesteps[:4])
    state = tw.state_dict()
    _, fresh = _wrappers(name, SCALED_CONFIG, torch.float64)
    fresh.set_timesteps(STEPS, device="cpu")
    fresh.load_state_dict(state)
    assert torch.equal(_drive(fresh, half, 1, timesteps=fresh.timesteps[4:]), want)
    fresh.set_timesteps(STEPS - 1, device="cpu")
    with pytest.raises(ValueError, match="steps"):
        fresh.load_state_dict(state)


def test_schedule_tensors_default_to_the_card() -> None:
    "Without ``set_timesteps(device=)`` the schedule tensors go to CUDA, which raises here rather than falling back."
    _, tw = _wrappers("dpm2", SCALED_CONFIG, torch.float32)
    tw.set_timesteps(STEPS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tw.timesteps  # noqa: B018
    tw.set_timesteps(STEPS, device="cpu")
    assert tw.timesteps.device.type == "cpu" and tw.sigmas.shape == (STEPS + 1,)


# ---- the RK wrappers -----------------------------------------------------------------------


@pytest.mark.parametrize(
    ("cls", "order", "stochasticity", "config"),
    [
        ("RKUltraWrapperScheduler", 2, 0.0, FLOW_CONFIG),
        ("RKUltraWrapperScheduler", 4, 0.0, SCALED_CONFIG),
        ("RKUltraWrapperScheduler", 3, 0.5, FLOW_CONFIG),
        ("DynasauRKWrapperScheduler", 3, 0.0, SCALED_CONFIG),
    ],
)
def test_rk_wrappers_match_jax(cls: str, order: int, stochasticity: float, config: dict) -> None:
    "The inside-out RK wrappers: the presented stage timesteps and the whole loop bit for bit at f32."
    jw, tw = (
        getattr(pkg, cls).from_diffusers_config(config, sampler_order=order, stochasticity=stochasticity)
        for pkg in (jd, td)
    )
    jw.set_timesteps(5)
    tw.set_timesteps(5, device="cpu")
    assert torch.equal(tw.timesteps, jw.timesteps) and tw.order == jw.order
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(SHAPE)).float()
    want = _drive(jw, x, 2)
    assert torch.equal(_drive(tw, x, 2), want)


# ---- the discrete oracle tier, as tests/test_discrete_parity.py runs it ---------------------


def _oracle_wrapper(sampler, steps: int):
    timesteps, sigmas = oracle.euler_discrete_grid(steps)
    schedule = tsched.FixedSchedule.from_regular(timesteps, sigmas, tsched.VariancePreserving())
    wrapper = td.SkrampleWrapperScheduler(sampler, schedule, tmodels.NoiseModel(), compute_scale=torch.float64)
    wrapper.set_timesteps(steps, device="cpu")
    return wrapper, timesteps, sigmas


def _pseudo_eps(x, timestep):
    return 0.8 * x + math.sin(float(timestep) / 300.0) * 0.3


@pytest.mark.parametrize(("sampler", "order"), [("euler", 1), ("dpm", 1), ("dpm", 2), ("euler-a", 1)])
def test_wrapper_matches_discrete_oracles(sampler: str, order: int) -> None:
    """The wrapper driven like a pipeline over the oracle's discrete grid against the independently written
    Euler, Euler-ancestral and DPM++(2M) updates: MSE <= 1e-8."""
    steps = 12
    build = {"euler": tstruct.Euler(), "dpm": tstruct.DPM(order=order), "euler-a": tstruct.DPM(order=1,
                                                                                              stochasticity=1.0)}
    wrapper, timesteps, sigmas = _oracle_wrapper(build[sampler], steps)
    rng = np.random.default_rng(13)
    x0 = rng.standard_normal(SHAPE)
    noises = [rng.standard_normal(SHAPE) for _ in range(steps)]
    wrapper.get_step_noise = lambda step, *_args, **_kw: torch.from_numpy(noises[round(step.position())])
    latent = torch.from_numpy(x0.copy())
    for t in wrapper.timesteps:
        latent = wrapper.step(_pseudo_eps(latent, t), t, latent).prev_sample

    reg = np.concatenate([sigmas, [0.0]])
    if sampler == "dpm":
        want = oracle.dpmpp_2m_trajectory(x0.copy(), lambda x, t, _s: _pseudo_eps(x, t), timesteps, sigmas, order)
    else:
        want = x0.copy()
        for n, t in enumerate(timesteps):
            if sampler == "euler-a" and reg[n + 1] > 0:
                want = oracle.ancestral_step(want, _pseudo_eps(want, t), reg[n], reg[n + 1], noises[n])
            else:
                want = oracle.euler_step(want, _pseudo_eps(want, t), reg[n], reg[n + 1])
    assert float(np.mean((latent.numpy() - want) ** 2)) <= 1e-8


@pytest.mark.parametrize("mu", [0.5, 1.15])
def test_flowmatch_mu_loop_matches_discrete(mu: float) -> None:
    "``set_timesteps(mu=)``: the published dynamic-shifting grid and the straight-line loop over it."
    steps = 9
    t_oracle, s_oracle = oracle.flowmatch_dynamic_grid(steps, mu)
    wrapper = td.SkrampleWrapperScheduler(
        tstruct.Euler(), tsched.FlowShift(tsched.Linear()), tmodels.FlowModel(), compute_scale=torch.float64
    )
    wrapper.set_timesteps(steps, device="cpu", mu=mu)
    np.testing.assert_allclose(wrapper.sigmas.numpy()[:steps], s_oracle, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(wrapper.timesteps.numpy(), t_oracle, rtol=1e-9, atol=1e-9)

    def velocity(x, t):
        return 0.7 * x - math.cos(t / 500.0) * 0.2

    x0 = np.random.default_rng(14).standard_normal(SHAPE)
    latent = torch.from_numpy(x0.copy())
    for t in wrapper.timesteps:
        latent = wrapper.step(velocity(latent, float(t)), t, latent).prev_sample
    reg = np.concatenate([s_oracle, [0.0]])
    x = x0.copy()
    for n in range(steps):
        x = x + (reg[n + 1] - reg[n]) * velocity(x, reg[n] * 1000.0)
    assert float(np.mean((latent.numpy() - x) ** 2)) <= 1e-8


# ---- the torch-facing noise adapters ---------------------------------------------------------


NOISE_PROPS = {
    "Offset": lambda p: p.OffsetProps(dims=(0, 1), strength=0.5),
    "Pyramid": lambda p: p.PyramidProps(strength=0.4, depth=3),
    "Brownian": lambda p: p.BrownianProps(max_steps=100),
    "Colored": lambda p: p.ColoredProps(energy=1.5, color_curve=1.0),
}


@pytest.mark.parametrize("name", ["Random", "Offset", "Pyramid", "Brownian", "Colored"])
def test_torch_noise_matches_jax(name: str) -> None:
    """Each adapter from a seeded ``torch.Generator``, three draws at steps 0, 3 and 7 of 8: Random and
    Offset (the caller's stream) bit for bit; Pyramid, Brownian and Colored (the counter-based families
    keyed off the seed) within 1e-4, PR 13's tolerance for the noise generators."""
    shape = SHAPE[1:]
    draws = []
    for pkg in (jtn, ttn):
        props = NOISE_PROPS[name](pkg) if name in NOISE_PROPS else None
        gen = getattr(pkg, name).from_inputs(shape, torch.Generator().manual_seed(21), props)
        draws.append([gen.generate(jd.Step.from_int(n, 8)) for n in (0, 3, 7)])
    for want, got in zip(*draws, strict=True):
        assert got.shape == shape and got.dtype == torch.float32
        if name in ("Random", "Offset"):
            assert torch.equal(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)
    batch = ttn.BatchTensorNoise.from_batch_inputs(ttn.Random, shape, [torch.Generator().manual_seed(s)
                                                                       for s in (1, 2)])
    jbatch = jtn.BatchTensorNoise.from_batch_inputs(jtn.Random, shape, [torch.Generator().manual_seed(s)
                                                                        for s in (1, 2)])
    assert torch.equal(batch.generate(None), jbatch.generate(None))


def test_counter_noise_through_the_wrapper_matches_jax() -> None:
    "``noise_type`` a counter-based family (Brownian): stochastic DPM's loop within 1e-4 of the JAX wrapper's."
    from skrample_tpu import noise as jnoise
    from skrample_tpu_torch import noise as tnoise

    results = []
    for pkg, struct, noise_type, sched, mods, extra in (
        (jd, jstruct, jnoise.Brownian, jsched, jmodels, {}),
        (td, tstruct, tnoise.Brownian, tsched, tmodels, {"device": "cpu"}),
    ):
        w = pkg.SkrampleWrapperScheduler(
            struct.DPM(order=2, stochasticity=1.0), sched.Scaled(), mods.NoiseModel(), noise_type=noise_type
        )
        w.set_timesteps(STEPS, **extra)
        x = torch.from_numpy(np.random.default_rng(15).standard_normal(SHAPE)).float()
        results.append(_drive(w, x, seed=17))
    np.testing.assert_allclose(results[1].numpy(), results[0].numpy(), rtol=0, atol=1e-4)
