"""Port parity: DDIM-25 windows and streams with injected noise equal JAX's.

The port's sampler cannot reproduce threefry draws, so the noise it uses
is replayed from the JAX key chain into a ``TableNoise`` (window key ->
x_T; per step the RePaint GT noise, the undo noise and, at eta > 0, the
DDIM noise).  Both sides run the same step on the same perturbed weights:
the streamlined eta=0 step (``fused_step='jnp'``), its kernel
(``fused_step='on'``: JAX's Pallas kernel in interpret mode, the port's
plain version on the CPU) or the general step (``fused_step='off'``).  A random model's epsilon is not the sample's noise,
so DDIM amplifies it (x0 = r x - rm1 eps with r ~ 150 at the first
level) and samples reach ~1e5: tolerances are relative to the window's
scale — rel-RMS <= 1e-5 and max-abs <= 1e-5 of max |ref| (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diffsheg_tpu.sampling.generator import WindowGenerator as JGen  # noqa: E402
from diffsheg_tpu_torch.diffusion.sampler import TableNoise  # noqa: E402
from diffsheg_tpu_torch.sampling.generator import WindowGenerator as PGen  # noqa: E402
from torch_parity import (config_pair, jax_denoiser,  # noqa: E402
                          jax_window_noise, rel_rms, torch_denoiser)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = config_pair("beat", diffusion={"jump_n_sample": 2})
    variables = jax_denoiser(jcfg, seed=21)
    jgen = JGen(jcfg, jax.tree.map(jnp.asarray, variables))
    pgen = PGen(tcfg, torch_denoiser(tcfg, variables), device="cpu")
    m = jcfg.model
    B, T = 2, jcfg.data.n_poses
    rng = np.random.RandomState(22)
    inputs = dict(
        mel=rng.randn(B, T, m.audio_dim).astype(np.float32),
        pid=np.eye(m.style_dim, dtype=np.float32)[[3, 7]],
        hub=rng.randn(B, T, m.hubert_dim).astype(np.float32),
        head=0.5 * rng.randn(B, jcfg.stream.overlap_len,
                             m.motion_dim).astype(np.float32))
    return jcfg, jgen, pgen, inputs


def _noise(key, jgen, shape, repaint):
    prog = jgen._harmonize if repaint else jgen._plain
    init, steps = jax_window_noise(key, *shape, prog, repaint)
    return TableNoise({0: init}, {(0, s, k): v for (s, k), v in steps.items()})


def _compare(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = rel_rms(got, ref), np.abs(got - ref).max() / np.abs(ref).max()
    assert err[0] <= 1e-5 and err[1] <= 1e-5, err


@pytest.mark.parametrize("repaint", [False, True], ids=["plain", "repaint"])
def test_window_matches_jax(setup, repaint):
    jcfg, jgen, pgen, d = setup
    key = jax.random.PRNGKey(23)
    B, T = d["mel"].shape[:2]
    C = jcfg.model.motion_dim
    head = d["head"] if repaint else None
    ref = jgen.generate(jnp.asarray(d["mel"]), jnp.asarray(d["pid"]), key,
                        jnp.asarray(d["hub"]),
                        gt_head=None if head is None else jnp.asarray(head))
    got = pgen.generate(torch.tensor(d["mel"]), torch.tensor(d["pid"]),
                        _noise(key, jgen, (B, T, C), repaint),
                        torch.tensor(d["hub"]),
                        gt_head=None if head is None else torch.tensor(head))
    _compare(got.numpy(), ref)
    if repaint:
        # the RePaint projection pins the first overlap frame to the head
        np.testing.assert_allclose(got[:, 0].numpy(), head[:, 0], atol=1e-5)


def test_model_call_counts(setup):
    _, jgen, pgen, _ = setup
    assert pgen.num_model_calls_plain == jgen.num_model_calls_plain == 25
    assert pgen.num_model_calls_repaint == jgen.num_model_calls_repaint == 27


def test_unported_modes_raise():
    # ancestral sampling is ported (tests/test_torch_ancestral.py holds it
    # against JAX); what stays refused is JAX's own refusal, ancestral
    # with saved noisy tails, a ValueError as in JAX
    import dataclasses
    _, tcfg = config_pair("beat")
    from diffsheg_tpu_torch.models.unidiffuser import init_unidiffuser
    model = init_unidiffuser(tcfg.model)
    cfg = tcfg.replace(diffusion=dataclasses.replace(tcfg.diffusion,
                                                     sampler="ancestral"))
    assert PGen(cfg, model, device="cpu").ancestral
    cfg = cfg.replace(stream=dataclasses.replace(cfg.stream,
                                                 same_overlap_noisy=True))
    with pytest.raises(ValueError, match="same_overlap_noisy"):
        PGen(cfg, model, device="cpu")


@pytest.mark.parametrize("over,cache,fast,step", [
    ({}, True, True, "jnp"),
    ({"fused_layer": "off"}, True, False, "jnp"),
    ({"level_cache": False}, False, False, "jnp"),
    ({"fused_step": "off"}, True, True, "none"),
    ({"fused_step": "on"}, True, True, "kernel"),
    ({"respacing": "", "num_steps": 100}, False, False, "jnp"),
], ids=["default", "fused_layer_off", "no_level_cache", "step_off",
        "step_on", "100_steps"])
def test_path_selection(over, cache, fast, step):
    # the JAX generator's selection: the cache for <= 64 respaced steps,
    # the fast path only on the cache
    import dataclasses
    from diffsheg_tpu_torch.models.unidiffuser import init_unidiffuser
    _, tcfg = config_pair("beat")
    cfg = tcfg.replace(diffusion=dataclasses.replace(tcfg.diffusion, **over))
    gen = PGen(cfg, init_unidiffuser(cfg.model), device="cpu")
    assert (gen.use_cache, gen.use_fast, gen.step_mode) == (cache, fast, step)
    T = cfg.data.n_poses
    assert (gen.make_fast(T) is None) == (not fast)
    assert (gen.cache_static(torch.eye(30)[:1]) is None) == (not cache)


def test_ddim_eta_matches_jax():
    # eta = 0.5 on the general step: the DDIM noise is replayed from JAX's
    # k_model draws; a harmonize program with RePaint, and a cheap linear
    # denoiser standing in for the model
    from diffsheg_tpu.diffusion import jump as JJ
    from diffsheg_tpu.diffusion import respace as JR
    from diffsheg_tpu.diffusion import sampler as JS
    from diffsheg_tpu.diffusion.schedule import get_named_beta_schedule
    from diffsheg_tpu_torch.diffusion import jump as PJ
    from diffsheg_tpu_torch.diffusion import respace as PR
    from diffsheg_tpu_torch.diffusion import sampler as PS
    betas = get_named_beta_schedule("linear", 1000)
    jsched, _ = JR.make_respaced_schedule(betas,
                                          JR.space_timesteps(1000, "ddim25"))
    psched, _ = PR.make_respaced_schedule(betas,
                                          PR.space_timesteps(1000, "ddim25"))
    jprog = JJ.make_step_program(JJ.jump_schedule_ddim(25, 3, 2))
    pprog = PJ.make_step_program(PJ.jump_schedule_ddim(25, 3, 2))
    B, T, C = 1, 34, 192
    rng = np.random.RandomState(28)
    w = (0.05 * rng.randn(C, C)).astype(np.float32)
    gt = rng.randn(B, T, C).astype(np.float32)
    key = jax.random.PRNGKey(29)
    k_rng, k = jax.random.split(key)
    spec = dict(overlap_len=4, add_blend=True)
    ref, _ = JS.ddim_sample_program(
        jsched, lambda x, t: x @ jnp.asarray(w), jprog,
        jax.random.normal(k, (B, T, C)), k_rng, eta=0.5,
        repaint=JS.RepaintSpec(**spec), gt=jnp.asarray(gt))
    init, steps = jax_window_noise(key, B, T, C, jprog, True,
                                   model_noise=True)
    noise = TableNoise({0: init},
                       {(0, s, kd): v for (s, kd), v in steps.items()})
    got, _ = PS.ddim_sample_program(
        psched, lambda x, t: x @ torch.tensor(w), pprog, noise, 0,
        (B, T, C), "cpu", repaint=PS.RepaintSpec(**spec),
        gt=torch.tensor(gt), eta=0.5, fused_step="none")
    _compare(got.numpy(), ref)


STREAMS = {
    "cache_step_on": dict(fused_layer="off", fused_step="on"),
    "uncached_step_off": dict(fused_layer="off", level_cache=False,
                              fused_step="off"),
    "uncached_start_x": dict(fused_layer="off", level_cache=False,
                             fused_step="off", mean_type="start_x"),
    "cache_clip": dict(fused_layer="off", fused_step="off",
                       clip_denoised=True),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_module_forward_stream_matches_jax(name):
    # three windows (0, 30 and a left-shifted 46) through the module
    # forward, fed by the level cache or uncached, with the step kernel
    # or the general step
    from diffsheg_tpu.sampling.streamer import StreamingGenerator as JS
    from diffsheg_tpu_torch.sampling.streamer import StreamingGenerator as PS
    from torch_parity import stream_noise
    jcfg, tcfg = config_pair("beat", diffusion=dict(jump_n_sample=2,
                                                    **STREAMS[name]))
    variables = jax_denoiser(jcfg, seed=30)
    jgen = JGen(jcfg, jax.tree.map(jnp.asarray, variables))
    pgen = PGen(tcfg, torch_denoiser(tcfg, variables), device="cpu")
    assert not pgen.use_fast and pgen.use_cache == jgen._use_level_cache
    m = jcfg.model
    rng = np.random.RandomState(31)
    T = 80
    mel = rng.randn(1, T, m.audio_dim).astype(np.float32)
    hub = rng.randn(1, T, m.hubert_dim).astype(np.float32)
    pid = np.eye(m.style_dim, dtype=np.float32)[[6]]
    key = jax.random.PRNGKey(32)
    ref = JS(jgen).generate_fused(jnp.asarray(mel), jnp.asarray(pid), key,
                                  jnp.asarray(hub))
    noise = stream_noise(key, 3, 1, 34, m.motion_dim, jgen._plain,
                         jgen._harmonize)
    got = PS(pgen).generate_fused(torch.tensor(mel), torch.tensor(pid),
                                  noise, torch.tensor(hub))
    _compare(got.numpy(), ref)


def test_stream_with_saved_tails_matches_jax():
    # same_overlap_noisy: each continuation window's head takes the
    # previous window's noisy tail per level (prev_tails_valid from the
    # second window on); two windows of a 64-frame stream
    from diffsheg_tpu.sampling.streamer import StreamingGenerator as JS
    from diffsheg_tpu_torch.sampling.streamer import StreamingGenerator as PS
    from torch_parity import stream_noise
    jcfg, tcfg = config_pair("beat", diffusion={"jump_n_sample": 2},
                             stream={"same_overlap_noisy": True})
    variables = jax_denoiser(jcfg, seed=24)
    jgen = JGen(jcfg, jax.tree.map(jnp.asarray, variables))
    pgen = PGen(tcfg, torch_denoiser(tcfg, variables), device="cpu")
    m = jcfg.model
    rng = np.random.RandomState(25)
    T = 64
    mel = rng.randn(1, T, m.audio_dim).astype(np.float32)
    hub = rng.randn(1, T, m.hubert_dim).astype(np.float32)
    pid = np.eye(m.style_dim, dtype=np.float32)[[4]]
    key = jax.random.PRNGKey(26)
    ref = JS(jgen).generate_fused(jnp.asarray(mel), jnp.asarray(pid), key,
                                  jnp.asarray(hub))
    noise = stream_noise(key, 2, 1, 34, m.motion_dim, jgen._plain,
                         jgen._harmonize)
    got = PS(pgen).generate_fused(torch.tensor(mel), torch.tensor(pid),
                                  noise, torch.tensor(hub))
    _compare(got.numpy(), ref)


def test_unported_stream_and_hubert_modes_raise():
    import dataclasses
    from diffsheg_tpu_torch.models.hubert import HubertConfig, HubertModel
    from diffsheg_tpu_torch.models.unidiffuser import init_unidiffuser
    from diffsheg_tpu_torch.sampling.streamer import StreamingGenerator
    _, tcfg = config_pair("beat")
    # stream.fix_very_first and ancestral streams are ported
    # (tests/test_torch_live.py and tests/test_torch_ancestral.py hold them
    # against JAX); ancestral with saved noisy tails is refused as JAX
    # refuses it; the HuBERT-base layout builds
    # (tests/test_torch_hubert_base.py holds it against JAX)
    cfg = tcfg.replace(stream=dataclasses.replace(tcfg.stream,
                                                  fix_very_first=True))
    StreamingGenerator(PGen(cfg, init_unidiffuser(cfg.model), device="cpu"))
    cfg = tcfg.replace(diffusion=dataclasses.replace(tcfg.diffusion,
                                                     sampler="ancestral"))
    StreamingGenerator(PGen(cfg, init_unidiffuser(cfg.model), device="cpu"))
    cfg = cfg.replace(stream=dataclasses.replace(cfg.stream,
                                                 same_overlap_noisy=True))
    with pytest.raises(ValueError, match="same_overlap_noisy"):
        StreamingGenerator(PGen(cfg, init_unidiffuser(cfg.model), device="cpu"))
    base = HubertModel(HubertConfig(conv_norm="group_first",
                                    stable_layer_norm=False, conv_bias=False,
                                    hidden_size=16, num_layers=1, num_heads=2,
                                    intermediate_size=32, conv_dim=(8,) * 7))
    assert base.feature_extractor.gn_scale.shape == (8,)
    with torch.no_grad():
        out = base(torch.zeros(1, 800))
    assert out.shape == (1, 2, 16) and torch.isfinite(out).all()
