"""Port parity: the audio frontend, chunked HuBERT and the whole pipeline.

- mel: ``MelFrontend`` against JAX's (f32; FFT implementations differ:
  max-abs <= 2e-5 of the spectrogram's scale);
- HuBERT: a tiny encoder (the real conv geometry) through
  ``hubert_runner`` on 21 s of audio, whose second chunk is a padded and
  masked remainder (f32, 1e-4 relative and absolute); the motion-rate
  resample on its own (positions are f32 linspace values that two
  implementations may round one ulp apart: 1e-5 at 50 frames);
- pipeline: a three-window ``FusedPipeline`` stream (the last window
  left-shifted) against JAX's ``FusedPipeline`` on the same audio and
  replayed keys; the port runs the branch ("chain") kernel path, and
  both run the fully uncached forward with the step kernel.  Samples
  of a random model reach ~1e5 (see test_torch_sampler.py), so the bound
  is relative: rel-RMS <= 1e-4 and max-abs <= 1e-4 of max |ref|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (config_pair, jax_denoiser, perturb,  # noqa: E402
                          rel_rms, stream_noise, torch_denoiser)

HUB = dict(hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32,
           conv_dim=(8, 8, 8, 8, 8, 8, 8))


def _audio(n, seed):
    t = np.arange(n) / 16000.0
    rng = np.random.RandomState(seed)
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.1 * rng.randn(n)).astype(np.float32)[None]


def _hubert_pair(seed, scan=False):
    from diffsheg_tpu.audio.hubert_runner import HubertFeatureExtractor as JH
    from diffsheg_tpu.models.hubert import HubertConfig as JC
    from diffsheg_tpu.models.hubert import stack_layer_params
    from diffsheg_tpu_torch.audio.hubert_runner import HubertFeatureExtractor as PH
    from diffsheg_tpu_torch.compat.from_jax import load_flax_tree
    from diffsheg_tpu_torch.models.hubert import HubertConfig as PC
    from diffsheg_tpu_torch.models.hubert import HubertModel
    jh = JH(JC(**HUB), rng=jax.random.PRNGKey(seed))
    variables = perturb(jax.tree.map(np.asarray, dict(jh.variables)),
                        seed + 1)
    jh.variables = jax.tree.map(jnp.asarray, variables)
    if scan:
        variables = jax.tree.map(np.asarray, stack_layer_params(
            variables, HUB["num_layers"]))
    ph = PH(model=load_flax_tree(HubertModel(PC(**HUB)), variables),
            device="cpu")
    return jh, ph


def test_mel_matches_jax():
    from diffsheg_tpu.audio.mel import MelFrontend as JM
    from diffsheg_tpu_torch.audio.mel import MelFrontend as PM
    audio = _audio(18000 * 3, 0)
    ref = np.asarray(JM(sr=18000, hop=1200)(jnp.asarray(audio)))
    got = PM(sr=18000, hop=1200, device="cpu")(torch.tensor(audio)).numpy()
    assert got.shape == ref.shape == (1, 45, 128)
    assert np.abs(got - ref).max() <= 2e-5 * np.abs(ref).max()


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan"])
def test_hubert_runner_with_masked_remainder(scan):
    from diffsheg_tpu_torch.audio.hubert_runner import (CLIP_SAMPLES,
                                                        expected_frames)
    audio = _audio(CLIP_SAMPLES + 16000, 1)     # remainder chunk: 1 s
    jh, ph = _hubert_pair(2, scan)
    ref = np.asarray(jh(jnp.asarray(audio)))
    got = ph(torch.tensor(audio)).numpy()
    assert got.shape == ref.shape == (1, expected_frames(audio.shape[1]),
                                      HUB["hidden_size"])
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("new_len", [37, 50, 71])
def test_linear_resample_matches_jax(new_len):
    from diffsheg_tpu.audio.hubert_runner import linear_resample as jr
    from diffsheg_tpu_torch.audio.hubert_runner import linear_resample as pr
    x = np.random.RandomState(new_len).randn(2, 50, 6).astype(np.float32)
    np.testing.assert_allclose(pr(torch.tensor(x), new_len).numpy(),
                               np.asarray(jr(jnp.asarray(x), new_len)),
                               rtol=1e-5, atol=1e-5)


def _three_window_pipeline(diffusion, port_diffusion=None):
    """A three-window stream (windows at 0, 30 and 46) through JAX's and
    the port's ``FusedPipeline`` on the same audio and replayed keys."""
    from diffsheg_tpu.audio.mel import MelFrontend as JM
    from diffsheg_tpu.sampling.generator import WindowGenerator as JG
    from diffsheg_tpu.sampling.pipeline import FusedPipeline as JP
    from diffsheg_tpu.sampling.streamer import StreamingGenerator as JS
    from diffsheg_tpu_torch.audio.mel import MelFrontend as PM
    from diffsheg_tpu_torch.sampling.generator import WindowGenerator as PG
    from diffsheg_tpu_torch.sampling.pipeline import FusedPipeline as PP
    from diffsheg_tpu_torch.sampling.streamer import (StreamingGenerator as PS,
                                                      window_starts)

    jcfg, tcfg = config_pair("beat", model={"hubert_dim": HUB["hidden_size"]},
                             diffusion=dict(jump_n_sample=2, **diffusion))
    tcfg = tcfg.replace(diffusion=dataclasses.replace(
        tcfg.diffusion, **(port_diffusion or {})))
    variables = jax_denoiser(jcfg, seed=31)
    jh, ph = _hubert_pair(32)
    T = 80                                  # windows at 0, 30 and 46
    starts = window_starts(T, 34, 30)
    assert starts == [0, 30, 46]
    a18 = _audio(T * 1200, 33)
    a16 = _audio(T * 16000 // 15, 34)
    pid = np.eye(jcfg.model.style_dim, dtype=np.float32)[[2, 5]]
    rng = jax.random.PRNGKey(35)

    jgen = JG(jcfg, jax.tree.map(jnp.asarray, variables))
    jpipe = JP(JS(jgen), JM(sr=18000, hop=1200), jh)
    ref = np.asarray(jpipe(jnp.asarray(a18), jnp.asarray(a16),
                           jnp.asarray(pid), rng))

    pgen = PG(tcfg, torch_denoiser(tcfg, variables), device="cpu")
    ppipe = PP(PS(pgen), PM(sr=18000, hop=1200, device="cpu"), ph)
    noise = stream_noise(rng, len(starts), 2, 34, jcfg.model.motion_dim,
                         jgen._plain, jgen._harmonize)
    got = ppipe(torch.tensor(a18), torch.tensor(a16), torch.tensor(pid),
                noise).numpy()
    assert got.shape == ref.shape == (2, T, jcfg.model.motion_dim)
    assert np.isfinite(got).all()
    err = rel_rms(got, ref), np.abs(got - ref).max() / np.abs(ref).max()
    assert err[0] <= 1e-4 and err[1] <= 1e-4, err
    return pgen


def test_three_window_pipeline_matches_jax():
    _three_window_pipeline({}, {"fused_layer": "chain"})


def test_three_window_uncached_pipeline_matches_jax():
    # bench.py --check's reference path: the fully uncached module forward
    # (the audio encoder in every call), here with the step kernel
    pgen = _three_window_pipeline({"fused_layer": "off", "level_cache": False,
                                   "fused_step": "on"})
    assert (pgen.use_cache, pgen.use_fast, pgen.step_mode) == (False, False,
                                                               "kernel")
