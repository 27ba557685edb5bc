"""Port parity: the ancestral sampler and the VLB terms against JAX.

``diffusion/vlb.py``: every function on the same numpy inputs, <= 1e-6
absolute.  The ancestral program (``sampler='ancestral'``): the noise is
replayed from JAX's ancestral key chain (per step ``key, k_gt, k_trans,
k_undo = split(key, 4)``) into a ``TableNoise``; windows, continuation
windows (RePaint projection before the model call, undo at ``t + 1``) and
a 3-window stream through both generators, for every ``var_type`` and
mean type, rel-RMS and max-abs <= 1e-5 of the window's scale (f32, as
``tests/test_torch_sampler.py`` holds DDIM).

A random model's variance head is unbounded: its raw output grows with the
sample, which the random epsilon inflates, until ``exp(log_var / 2)``
overflows float32 — NaN in both packages.  The learned-variance models
here therefore get a variance head that emits a per-channel constant in
[-1, 1] (zero weights, uniform biases), where a trained head's output
lies; the mean half and every other weight stay random.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diffsheg_tpu.diffusion import vlb as JV  # noqa: E402
from diffsheg_tpu.diffusion.respace import (  # noqa: E402
    make_respaced_schedule as j_respace, space_timesteps)
from diffsheg_tpu.diffusion.schedule import get_named_beta_schedule  # noqa: E402
from diffsheg_tpu_torch.diffusion import vlb as PV  # noqa: E402
from diffsheg_tpu_torch.diffusion.respace import (  # noqa: E402
    make_respaced_schedule as p_respace)
from diffsheg_tpu_torch.diffusion.sampler import TableNoise  # noqa: E402
from torch_parity import (config_pair, jax_denoiser,  # noqa: E402
                          jax_window_noise, rel_rms, stream_noise,
                          torch_denoiser)


def _schedules(spacing="ddim25"):
    betas = get_named_beta_schedule("linear", 1000)
    use = space_timesteps(1000, spacing)
    return j_respace(betas, use)[0], p_respace(betas, use)[0]


@pytest.fixture(scope="module")
def vlb_inputs():
    """Inputs at the scales training feeds the terms: x_t drawn from
    q(x_t | x_0) at levels 0, 3, 12 and 24 of DDIM-25, predictions near
    the truth (means within a posterior std, log-variances within 0.1).
    The t = 0 term's bin probability is then a difference of two CDFs that
    do not cancel to their last bits (with |x - mean| many stds wide it
    does, and float32 tanh implementations differ there)."""
    _, ps = _schedules()
    rng = np.random.RandomState(71)
    B, T, C = 4, 6, 5
    t = np.array([0, 3, 12, 24])
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    col = lambda tab: np.asarray(tab, np.float32)[t][:, None, None]  # noqa
    x0 = np.clip(0.6 * f(B, T, C), -1, 1)
    x0[0, 0, :2] = (-1.0, 1.0)                 # both bin edges
    noise = f(B, T, C)
    xt = col(ps.sqrt_alphas_cumprod) * x0 + col(
        ps.sqrt_one_minus_alphas_cumprod) * noise
    true_mean = (col(ps.posterior_mean_coef1) * x0
                 + col(ps.posterior_mean_coef2) * xt)
    true_logvar = np.broadcast_to(col(ps.posterior_log_variance_clipped),
                                  (B, T, C))
    std = np.exp(0.5 * true_logvar)
    return dict(t=t, x0=x0, xt=xt, noise=noise, true_mean=true_mean,
                mean=true_mean + 0.5 * std * f(B, T, C),
                logvar=true_logvar + 0.1 * f(B, T, C),
                raw=rng.uniform(-1, 1, (B, T, C)).astype(np.float32),
                eps_err=0.05 * f(B, T, C))


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_vlb_elementwise_match_jax(vlb_inputs):
    d = vlb_inputs
    j, p = jnp.asarray, torch.tensor
    _close(PV.normal_kl(p(d["true_mean"]), p(d["logvar"]), p(d["mean"]),
                        p(d["logvar"] - 0.2)).numpy(),
           JV.normal_kl(j(d["true_mean"]), j(d["logvar"]), j(d["mean"]),
                        j(d["logvar"] - 0.2)))
    _close(PV.approx_standard_normal_cdf(p(d["noise"])).numpy(),
           JV.approx_standard_normal_cdf(j(d["noise"])))
    # the t = 0 row: data against means within a posterior std
    x, mean, ls = (d[k][:1] for k in ("x0", "mean", "logvar"))
    _close(PV.discretized_gaussian_log_likelihood(
        p(x), p(mean), p(0.5 * ls)).numpy(),
        JV.discretized_gaussian_log_likelihood(j(x), j(mean), j(0.5 * ls)))
    out = np.concatenate([d["mean"], d["raw"]], axis=-1)
    pm, pv = PV.split_learned_variance(p(out))
    jm, jv = JV.split_learned_variance(j(out))
    _close(pm.numpy(), jm)
    _close(pv.numpy(), jv)


def test_vlb_terms_match_jax(vlb_inputs):
    d = vlb_inputs
    js, ps = _schedules()
    j, p = jnp.asarray, torch.tensor
    t_j, t_p = j(d["t"]), torch.tensor(d["t"])
    _close(PV.learned_range_logvar(ps, p(d["raw"]), t_p).numpy(),
           JV.learned_range_logvar(js, j(d["raw"]), t_j))
    # one level as a python int, as the sampler's host loop passes it
    _close(PV.learned_range_logvar(ps, p(d["raw"]), 7).numpy(),
           JV.learned_range_logvar(js, j(d["raw"]), jnp.full((4,), 7)))
    _close(PV.vlb_term(ps, p(d["x0"]), p(d["xt"]), t_p, p(d["mean"]),
                       p(d["logvar"])).numpy(),
           JV.vlb_term(js, j(d["x0"]), j(d["xt"]), t_j, j(d["mean"]),
                       j(d["logvar"])))
    # each mean type's prediction near the truth, each variance head
    means = {"epsilon": d["noise"] + d["eps_err"],
             "start_x": d["x0"] + 0.01 * d["eps_err"],
             "previous_x": d["mean"]}
    var = {"learned": d["logvar"], "learned_range": d["raw"]}
    for mean_type, mean_part in means.items():
        for var_type, var_part in var.items():
            out = np.concatenate([mean_part, var_part], axis=-1)
            for clip in (False, True):
                kw = dict(mean_type=mean_type, var_type=var_type,
                          clip_denoised=clip)
                _close(PV.vb_term_from_output(
                    ps, p(d["x0"]), p(d["xt"]), t_p, p(out),
                    freeze_mean=True, **kw).numpy(),
                    JV.vb_term_from_output(js, j(d["x0"]), j(d["xt"]), t_j,
                                           j(out), **kw))
    _close(PV.prior_kl(ps, p(d["x0"])).numpy(), JV.prior_kl(js, j(d["x0"])))


@pytest.mark.parametrize("var_type", ["fixed_small", "fixed_large",
                                      "learned", "learned_range"])
def test_model_log_variance_matches_jax(var_type):
    from diffsheg_tpu.diffusion.sampler import model_log_variance as jlv
    from diffsheg_tpu_torch.diffusion.sampler import model_log_variance as plv
    js, ps = _schedules()
    raw = np.random.RandomState(72).uniform(-1, 1, (2, 3, 4)).astype(
        np.float32)
    for t in (0, 1, 13, 24):
        ref = jlv(js, var_type, jnp.asarray(raw), jnp.full((2,), t), 3)
        got = plv(ps, var_type, torch.tensor(raw), t)
        got = got.numpy() if torch.is_tensor(got) else np.float32(got)
        np.testing.assert_allclose(np.broadcast_to(got, np.shape(ref)),
                                   np.asarray(ref), rtol=0, atol=1e-6)


def test_ancestral_program_matches_jax():
    # the program on its own, with JAX's default plain program (every
    # level of a 50-step schedule) and with a jump program, a cheap linear
    # stand-in for the model (mean half a linear map, variance half a
    # bounded function of it), previous_x means and clipping
    from diffsheg_tpu.diffusion import jump as JJ
    from diffsheg_tpu.diffusion import sampler as JS
    from diffsheg_tpu_torch.diffusion import jump as PJ
    from diffsheg_tpu_torch.diffusion import sampler as PS
    js, ps = _schedules("50")
    B, T, C = 2, 12, 6
    rng = np.random.RandomState(73)
    w = (0.1 * rng.randn(C, 2 * C)).astype(np.float32)
    gt = rng.randn(B, T, C).astype(np.float32)
    spec = dict(overlap_len=3, add_blend=True)
    cases = (("learned_range", "epsilon", False, None, None),
             ("learned", "previous_x", False, None, None),
             ("fixed_large", "start_x", True,
              JJ.make_step_program(JJ.jump_schedule(30, 3, 2)),
              PJ.make_step_program(PJ.jump_schedule(30, 3, 2))))
    for var_type, mean_type, clip, jprog, pprog in cases:
        wv = w if var_type.startswith("learned") else w[:, :C]
        key = jax.random.PRNGKey(74)
        k_rng, k = jax.random.split(key)
        ref = JS.ancestral_sample_program(
            js, lambda x, t: jnp.tanh(x @ jnp.asarray(wv)),
            jax.random.normal(k, (B, T, C)), k_rng, mean_type=mean_type,
            var_type=var_type, clip_denoised=clip, program=jprog,
            repaint=JS.RepaintSpec(**spec), gt=jnp.asarray(gt))
        program = pprog if pprog is not None else PJ.plain_program(50)
        init, steps = jax_window_noise(key, B, T, C, program, True,
                                       sampler="ancestral")
        noise = TableNoise({0: init},
                           {(0, s, kd): v for (s, kd), v in steps.items()})
        got = PS.ancestral_sample_program(
            ps, lambda x, t: torch.tanh(x @ torch.tensor(wv)), pprog, noise,
            0, (B, T, C), "cpu", repaint=PS.RepaintSpec(**spec),
            gt=torch.tensor(gt), mean_type=mean_type, var_type=var_type,
            clip_denoised=clip)
        _compare(got.numpy(), ref)


def _compare(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = rel_rms(got, ref), np.abs(got - ref).max() / np.abs(ref).max()
    assert err[0] <= 1e-5 and err[1] <= 1e-5, err


def bound_variance_head(variables, seed):
    """The variance half of each branch's ``out`` head: zero weights and
    a uniform [-1, 1) bias (the module docstring says why)."""
    rng = np.random.RandomState(seed)
    params = variables["params"]
    for branch in params.values():
        out = branch.get("out") if isinstance(branch, dict) else None
        if out is None:
            continue
        n = out["bias"].shape[0] // 2
        out["kernel"][:, n:] = 0.0
        out["bias"][n:] = rng.uniform(-1, 1, n).astype(np.float32)
    return variables


def _setup(var_type, mean_type="epsilon", seed=75, **model):
    from diffsheg_tpu.sampling.generator import WindowGenerator as JGen
    from diffsheg_tpu_torch.sampling.generator import WindowGenerator as PGen
    learned = var_type in ("learned", "learned_range")
    jcfg, tcfg = config_pair(
        "beat", model=dict(latent_dim=32, num_layers=1, num_heads=2,
                           ff_size=64, add_hubert=False,
                           learned_variance=learned, **model),
        diffusion=dict(sampler="ancestral", var_type=var_type,
                       mean_type=mean_type, jump_n_sample=2))
    variables = jax_denoiser(jcfg, seed=seed)
    if learned:
        variables = bound_variance_head(variables, seed + 1)
    jgen = JGen(jcfg, jax.tree.map(jnp.asarray, variables))
    pgen = PGen(tcfg, torch_denoiser(tcfg, variables), device="cpu")
    return jcfg, jgen, pgen


@pytest.mark.parametrize("repaint", [False, True], ids=["plain", "repaint"])
@pytest.mark.parametrize("var_type,mean_type", [
    ("fixed_small", "epsilon"), ("fixed_large", "epsilon"),
    ("learned", "epsilon"), ("learned_range", "epsilon"),
    ("fixed_small", "start_x")])
def test_window_matches_jax(var_type, mean_type, repaint):
    from diffsheg_tpu.models.factory import denoised_channels
    jcfg, jgen, pgen = _setup(var_type, mean_type)
    assert pgen.ancestral
    m = jcfg.model
    B, T, C = 2, jcfg.data.n_poses, denoised_channels(m)
    rng = np.random.RandomState(76)
    mel = rng.randn(B, T, m.audio_dim).astype(np.float32)
    pid = np.eye(m.style_dim, dtype=np.float32)[[3, 7]]
    head = (0.5 * rng.randn(B, jcfg.stream.overlap_len, C).astype(np.float32)
            if repaint else None)
    key = jax.random.PRNGKey(77)
    ref = jgen.generate(jnp.asarray(mel), jnp.asarray(pid), key,
                        gt_head=None if head is None else jnp.asarray(head))
    prog = jgen._harmonize if repaint else jgen._plain
    init, steps = jax_window_noise(key, B, T, C, prog, repaint,
                                   sampler="ancestral")
    noise = TableNoise({0: init}, {(0, s, k): v for (s, k), v in steps.items()})
    got = pgen.generate(torch.tensor(mel), torch.tensor(pid), noise,
                        gt_head=None if head is None else torch.tensor(head))
    _compare(got.numpy(), ref)


def test_undo_levels_stay_inside_the_schedule():
    # the ancestral undo re-noises at t + 1; every jump program keeps that
    # below num_steps, so no table lookup leaves the schedule (JAX's
    # jnp.take would fill a level past the end with NaN)
    from diffsheg_tpu_torch.diffusion.jump import (jump_schedule_ddim,
                                                   make_step_program)
    for n, jl, jns in ((25, 3, 2), (25, 1, 1), (50, 3, 5), (10, 2, 3)):
        prog = make_step_program(jump_schedule_ddim(n, jl, jns))
        undo = prog.t[~prog.denoise]
        assert (undo + 1 < n).all(), (n, jl, jns)


@pytest.mark.parametrize("var_type,model", [
    ("learned_range", {}),
    ("fixed_small", dict(branch_mode="gesture_only", add_text_cond=True,
                         add_emo_cond=True, word_vocab=50, num_emotions=5)),
], ids=["joint_learned_range", "gesture_text_emo"])
def test_stream_matches_jax(var_type, model):
    # three windows (0, 30 and a left-shifted 46) of an 80-frame stream
    from diffsheg_tpu.models.factory import denoised_channels
    from diffsheg_tpu.sampling.streamer import StreamingGenerator as JS
    from diffsheg_tpu_torch.sampling.streamer import StreamingGenerator as PS
    jcfg, jgen, pgen = _setup(var_type, seed=78, **model)
    m = jcfg.model
    rng = np.random.RandomState(79)
    T = 80
    mel = rng.randn(1, T, m.audio_dim).astype(np.float32)
    pid = np.eye(m.style_dim, dtype=np.float32)[[6]]
    key = jax.random.PRNGKey(80)
    ref = JS(jgen).generate_fused(jnp.asarray(mel), jnp.asarray(pid), key)
    noise = stream_noise(key, 3, 1, 34, denoised_channels(m), jgen._plain,
                         jgen._harmonize, sampler="ancestral")
    got = PS(pgen).generate_fused(torch.tensor(mel), torch.tensor(pid),
                                  noise)
    assert got.shape == (1, T, denoised_channels(m))
    _compare(got.numpy(), ref)
