"""Port parity: DDIM-25 windows with injected noise equal JAX's.

The port's sampler cannot reproduce threefry draws, so the noise it uses
is replayed from the JAX key chain into a ``TableNoise`` (window key ->
x_T; per step the RePaint GT noise and the undo noise).  Both sides run
the streamlined eta=0 step (JAX ``fused_step='jnp'``) on the same
perturbed weights.  A random model's epsilon is not the sample's noise,
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
from torch_parity import (config_pair, jax_unidiffuser,  # noqa: E402
                          jax_window_noise, rel_rms, torch_unidiffuser)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = config_pair("beat", diffusion={"jump_n_sample": 2})
    variables = jax_unidiffuser(jcfg, seed=21)
    jgen = JGen(jcfg, jax.tree.map(jnp.asarray, variables))
    pgen = PGen(tcfg, torch_unidiffuser(tcfg, variables), device="cpu")
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
    import dataclasses
    _, tcfg = config_pair("beat")
    from diffsheg_tpu_torch.models.unidiffuser import init_unidiffuser
    model = init_unidiffuser(tcfg.model)
    for over in ({"fused_layer": "off"}, {"level_cache": False},
                 {"quantize": "int8"}, {"quantize": "int4"},
                 {"sampler": "ancestral"}, {"fused_step": "on"}):
        cfg = tcfg.replace(diffusion=dataclasses.replace(tcfg.diffusion, **over))
        with pytest.raises(NotImplementedError):
            PGen(cfg, model, device="cpu")


def test_stream_with_saved_tails_matches_jax():
    # same_overlap_noisy: each continuation window's head takes the
    # previous window's noisy tail per level (prev_tails_valid from the
    # second window on); two windows of a 64-frame stream
    from diffsheg_tpu.sampling.streamer import StreamingGenerator as JS
    from diffsheg_tpu_torch.sampling.streamer import StreamingGenerator as PS
    from torch_parity import stream_noise
    jcfg, tcfg = config_pair("beat", diffusion={"jump_n_sample": 2},
                             stream={"same_overlap_noisy": True})
    variables = jax_unidiffuser(jcfg, seed=24)
    jgen = JGen(jcfg, jax.tree.map(jnp.asarray, variables))
    pgen = PGen(tcfg, torch_unidiffuser(tcfg, variables), device="cpu")
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
    cfg = tcfg.replace(stream=dataclasses.replace(tcfg.stream,
                                                  fix_very_first=True))
    with pytest.raises(NotImplementedError):
        StreamingGenerator(PGen(cfg, init_unidiffuser(cfg.model), device="cpu"))
    with pytest.raises(NotImplementedError):
        HubertModel(HubertConfig(conv_norm="group_first",
                                 stable_layer_norm=False))
