"""Port parity: every model variant the JAX package builds, against JAX.

The same perturbed weights (made in JAX by ``init_denoiser``, carried into
the port by ``compat/from_jax.py``) and the same numpy inputs go through
both module forwards: the decoder base (cross-attention over the
condition), the learned-variance head with and without classifier-free
guidance, text and emotion conditioning, the three single-branch models,
and the ``scan_layers`` layouts; the cross-attention module alone; then
DDIM streams of the new models through the default generator, which runs
them uncached, and the refusals the JAX generator makes.  Forward: f32,
rtol = atol = 1e-4 (the ``tests/test_torch_denoiser.py`` standard); the
cross-attention alone 1e-5; streams rel-RMS and max-abs <= 1e-5 of the
stream's scale (``tests/test_torch_sampler.py``'s standard).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (config_pair, jax_denoiser, perturb,  # noqa: E402
                          rel_rms, stream_noise, torch_denoiser)

SQRT_ALPHAS = (1.3, 0.8)
SMALL = dict(latent_dim=32, num_layers=2, num_heads=2, ff_size=64)

VARIANTS = {
    "decoder": dict(model_base="transformer_decoder"),
    "decoder_cfg_scan": dict(model_base="transformer_decoder",
                             classifier_free=True, cond_scale=1.5,
                             scan_layers=True),
    "learned_var": dict(learned_variance=True),
    "learned_var_cfg": dict(learned_variance=True, classifier_free=True,
                            cond_scale=1.5),
    "text_emo": dict(add_text_cond=True, add_emo_cond=True, word_vocab=50,
                     num_emotions=5),
    "expression_only": dict(branch_mode="expression_only"),
    "gesture_only_scan": dict(branch_mode="gesture_only", scan_layers=True),
    "exp_condition_gesture": dict(branch_mode="exp_condition_gesture",
                                  classifier_free=True, cond_scale=1.5),
    "gesture_text_emo_decoder": dict(branch_mode="gesture_only",
                                     add_text_cond=True, add_emo_cond=True,
                                     word_vocab=50, num_emotions=5,
                                     model_base="transformer_decoder"),
}


def _var_type(model):
    return "learned_range" if model.get("learned_variance") else "fixed_small"


def _pair(model, diffusion=None, stream=None):
    return config_pair("beat", model=dict(SMALL, **model),
                       diffusion=dict({"var_type": _var_type(model)},
                                      **(diffusion or {})),
                       stream=stream)


def _inputs(jcfg, seed):
    from diffsheg_tpu.models.factory import denoised_channels
    m, T, B = jcfg.model, jcfg.data.n_poses, 2
    rng = np.random.RandomState(seed)
    d = dict(x=rng.randn(B, T, denoised_channels(m)).astype(np.float32),
             mel=rng.randn(B, T, m.audio_dim).astype(np.float32),
             pid=np.eye(m.style_dim, dtype=np.float32)[[1, 2]],
             hub=rng.randn(B, T, m.hubert_dim).astype(np.float32),
             t=np.array([40, 480], np.int32))
    if m.branch_mode == "exp_condition_gesture":
        d["exp_cond"] = rng.randn(B, T, m.expression_dim).astype(np.float32)
    if m.add_text_cond:     # -1 entries: the padding sentinel, clamped to 0
        d["word"] = rng.randint(-1, m.word_vocab, (B, T)).astype(np.int32)
    if m.add_emo_cond:
        d["emo"] = rng.randint(-1, m.num_emotions, (B, T)).astype(np.int32)
    return d


def _kw(d, tensor):
    return {k: tensor(d[k]) for k in ("exp_cond", "word", "emo") if k in d}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_matches_jax(name):
    from diffsheg_tpu.models.factory import build_denoiser
    jcfg, tcfg = _pair(VARIANTS[name])
    variables = jax_denoiser(jcfg, seed=51)
    d = _inputs(jcfg, 52)
    cfg_inf = jcfg.model.uses_cfg_at_inference
    a = {k: jnp.asarray(v) for k, v in d.items()}
    ref = np.asarray(build_denoiser(jcfg.model).apply(
        jax.tree.map(jnp.asarray, variables), a["x"], a["t"], SQRT_ALPHAS,
        a["mel"], a["pid"], hubert=a["hub"], train=False,
        cfg_inference=cfg_inf, **_kw(d, jnp.asarray)))
    model = torch_denoiser(tcfg, variables)
    p = {k: torch.tensor(v) for k, v in d.items()}
    with torch.no_grad():
        got = model(p["x"], p["t"], SQRT_ALPHAS, p["mel"], p["pid"],
                    hubert=p["hub"], cfg_inference=cfg_inf,
                    **_kw(d, torch.tensor)).numpy()
    C = d["x"].shape[-1] * (2 if jcfg.model.learned_variance else 1)
    assert got.shape == ref.shape == d["x"].shape[:2] + (C,)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_parameter_layouts():
    # what each variant builds, by the Flax names the loader fills
    from diffsheg_tpu_torch.models.factory import init_denoiser
    _, tcfg = _pair(VARIANTS["decoder"])
    layer = init_denoiser(tcfg.model).encoder_ges.layer_0
    assert hasattr(layer, "ca_block") and not hasattr(layer, "feat_proj")
    _, tcfg = _pair(VARIANTS["gesture_text_emo_decoder"])
    model = init_denoiser(tcfg.model)
    assert not hasattr(model, "encoder_aud")
    for name in ("text_embed", "text_tcn", "emotion_embed", "emotion_tail"):
        assert hasattr(model.encoder, name), name
    # the single branch projects the mel alone (audio_dim, not 2x)
    assert model.encoder.audio_proj.in_features == tcfg.model.audio_dim
    _, tcfg = _pair(VARIANTS["learned_var"])
    model = init_denoiser(tcfg.model)
    assert model.encoder_ges.out.out_features == 2 * tcfg.model.pose_dim


@pytest.mark.parametrize("memory_len", [34, 20], ids=["kernel", "composition"])
def test_cross_attention_matches_jax(memory_len):
    # queries from the normed latent, keys and values from a separately
    # normed memory of another width, no mask; a memory of another length
    # takes the composition (JAX's dispatch rule)
    from diffsheg_tpu.models.attention import LinearTemporalCrossAttention as JA
    from diffsheg_tpu_torch.compat.from_jax import load_flax_tree
    from diffsheg_tpu_torch.models.attention import (
        LinearTemporalCrossAttention as PA)
    B, T, L, M, E, H = 2, 34, 64, 48, 256, 4
    rng = np.random.RandomState(53)
    x = rng.randn(B, T, L).astype(np.float32)
    xf = rng.randn(B, memory_len, M).astype(np.float32)
    emb = rng.randn(B, E).astype(np.float32)
    jm = JA(L, H)
    params = jm.init(jax.random.PRNGKey(54), jnp.asarray(x), jnp.asarray(xf),
                     jnp.asarray(emb))["params"]
    params = perturb(jax.tree.map(np.asarray, dict(params)), 55)
    ref = np.asarray(jm.apply({"params": jax.tree.map(jnp.asarray, params)},
                              jnp.asarray(x), jnp.asarray(xf),
                              jnp.asarray(emb)))
    pm = load_flax_tree(PA(L, H, E, M), {"params": params})
    with torch.no_grad():
        got = pm(torch.tensor(x), torch.tensor(xf), torch.tensor(emb)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_exp_condition_gesture_sampling_raises_as_jax_does():
    # neither generator passes an expression condition, so sampling such a
    # model raises the model's own ValueError in both packages
    from diffsheg_tpu.sampling.generator import WindowGenerator as JGen
    from diffsheg_tpu_torch.diffusion.sampler import GeneratorNoise
    from diffsheg_tpu_torch.sampling.generator import WindowGenerator as PGen
    jcfg, tcfg = _pair(dict(branch_mode="exp_condition_gesture",
                            add_hubert=False))
    variables = jax_denoiser(jcfg, seed=56)
    mel = np.zeros((1, 34, 128), np.float32)
    pid = np.eye(30, dtype=np.float32)[[0]]
    with pytest.raises(ValueError, match="needs exp_cond"):
        JGen(jcfg, jax.tree.map(jnp.asarray, variables)).generate(
            jnp.asarray(mel), jnp.asarray(pid), jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="needs exp_cond"):
        PGen(tcfg, torch_denoiser(tcfg, variables), device="cpu").generate(
            torch.tensor(mel), torch.tensor(pid), GeneratorNoise(0, "cpu"))


def _refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("over", [
    dict(diffusion={"sampler": "ddpm"}),
    dict(diffusion={"sampler": "ancestral"},
         stream={"same_overlap_noisy": True}),
    dict(diffusion={"var_type": "learned"}),
    dict(model={"learned_variance": True}, diffusion={"var_type":
                                                      "fixed_large"}),
], ids=["unknown_sampler", "ancestral_saved_tails", "learned_without_head",
        "head_without_learned"])
def test_refusals_equal_jax(over):
    from diffsheg_tpu.config import resolve as jresolve
    from diffsheg_tpu.sampling.generator import WindowGenerator as JGen
    from diffsheg_tpu_torch.config import resolve as presolve
    from diffsheg_tpu_torch.models.factory import init_denoiser
    from diffsheg_tpu_torch.sampling.generator import WindowGenerator as PGen
    jcfg, tcfg = config_pair("beat", model=dict(SMALL, add_hubert=False,
                                                **over.get("model", {})),
                             diffusion=over.get("diffusion"),
                             stream=over.get("stream"))
    jmsg = _refusal(lambda: JGen(jcfg, {}))
    pmsg = _refusal(lambda: PGen(tcfg, init_denoiser(tcfg.model),
                                 device="cpu"))
    assert pmsg == jmsg
    if "var_type" in over["diffusion"]:      # resolve checks it too
        assert _refusal(lambda: presolve(tcfg)) == _refusal(
            lambda: jresolve(jcfg)) == jmsg


@pytest.mark.parametrize("name", ["decoder", "learned_var", "text_emo",
                                  "gesture_only_scan"])
def test_quantize_refused_as_jax_does(name):
    # none of these runs the fast path, the only quantized engine
    from diffsheg_tpu.sampling.generator import WindowGenerator as JGen
    from diffsheg_tpu_torch.models.factory import init_denoiser
    from diffsheg_tpu_torch.sampling.generator import WindowGenerator as PGen
    jcfg, tcfg = _pair(dict(VARIANTS[name], add_hubert=False),
                       diffusion={"quantize": "int8", "fused_layer": "on"})
    with pytest.raises(ValueError, match="quantize requires"):
        JGen(jcfg, {})
    with pytest.raises(ValueError, match="quantize requires"):
        PGen(tcfg, init_denoiser(tcfg.model), device="cpu")


STREAMS = {
    # the default generator (level_cache=True, fused_layer='auto'): these
    # models run uncached, as JAX's regression test requires
    "decoder_default": (VARIANTS["decoder"], {}),
    "learned_var_default": (VARIANTS["learned_var"], {}),
    "decoder_step_on": (VARIANTS["decoder"], {"fused_step": "on"}),
    "learned_var_cfg_step_on": (VARIANTS["learned_var_cfg"],
                                {"fused_step": "on"}),
    "gesture_text_emo_step_on": (
        dict(branch_mode="gesture_only", add_text_cond=True,
             add_emo_cond=True, word_vocab=50, num_emotions=5),
        {"fused_step": "on"}),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_matches_jax(name):
    # three windows (0, 30 and a left-shifted 46) of an 80-frame stream
    from diffsheg_tpu.models.factory import denoised_channels
    from diffsheg_tpu.sampling.generator import WindowGenerator as JGen
    from diffsheg_tpu.sampling.streamer import StreamingGenerator as JS
    from diffsheg_tpu_torch.sampling.generator import WindowGenerator as PGen
    from diffsheg_tpu_torch.sampling.streamer import StreamingGenerator as PS
    model, diffusion = STREAMS[name]
    jcfg, tcfg = _pair(model, diffusion=dict(jump_n_sample=2, **diffusion))
    assert jcfg.diffusion.level_cache and jcfg.diffusion.fused_layer == "auto"
    variables = jax_denoiser(jcfg, seed=58)
    jgen = JGen(jcfg, jax.tree.map(jnp.asarray, variables))
    pgen = PGen(tcfg, torch_denoiser(tcfg, variables), device="cpu")
    assert not jgen._use_level_cache and not pgen.use_cache
    assert not pgen.use_fast
    m = jcfg.model
    rng = np.random.RandomState(59)
    T = 80
    mel = rng.randn(1, T, m.audio_dim).astype(np.float32)
    hub = rng.randn(1, T, m.hubert_dim).astype(np.float32)
    pid = np.eye(m.style_dim, dtype=np.float32)[[6]]
    key = jax.random.PRNGKey(60)
    ref = np.asarray(JS(jgen).generate_fused(
        jnp.asarray(mel), jnp.asarray(pid), key, jnp.asarray(hub)))
    noise = stream_noise(key, 3, 1, 34, denoised_channels(m), jgen._plain,
                         jgen._harmonize)
    got = PS(pgen).generate_fused(torch.tensor(mel), torch.tensor(pid),
                                  noise, torch.tensor(hub)).numpy()
    assert got.shape == ref.shape == (1, T, denoised_channels(m))
    assert np.isfinite(got).all()
    err = rel_rms(got, ref), np.abs(got - ref).max() / np.abs(ref).max()
    assert err[0] <= 1e-5 and err[1] <= 1e-5, err


def test_coupled_variance_passes_resolve():
    # the learned head and a learned var_type pass together
    from diffsheg_tpu_torch.config import beat_config, resolve
    cfg = beat_config()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, learned_variance=True),
        diffusion=dataclasses.replace(cfg.diffusion, var_type="learned"))
    assert resolve(cfg).model.learned_variance


def test_step_kernel_gets_contiguous_mean_half(monkeypatch):
    # the kernel's wrapper refuses strided operands on the card; a
    # learned-variance output's mean half is a strided view, so the sampler
    # hands the step a contiguous copy (the plain version, run here on the
    # CPU, would not notice)
    import diffsheg_tpu_torch.diffusion.sampler as smp
    from diffsheg_tpu_torch.diffusion.sampler import GeneratorNoise
    from diffsheg_tpu_torch.models.factory import init_denoiser
    from diffsheg_tpu_torch.sampling.generator import WindowGenerator as PGen
    seen = []

    def spy(x, eps, *rest):
        seen.append(eps.is_contiguous() and eps.shape == x.shape)
        return smp.ddim_repaint_step_reference(x, eps, *rest)

    monkeypatch.setattr(smp, "fused_ddim_repaint_step", spy)
    _, tcfg = _pair(dict(VARIANTS["learned_var"], add_hubert=False,
                         num_layers=1), diffusion={"fused_step": "on"})
    gen = PGen(tcfg, init_denoiser(tcfg.model), device="cpu")
    out = gen.generate(torch.zeros(1, 34, 128), torch.eye(30)[:1],
                       GeneratorNoise(0, "cpu"))
    assert out.shape == (1, 34, 192) and torch.isfinite(out).all()
    assert len(seen) == 25 and all(seen)
