"""Port parity: the module forward ``UniDiffuser.forward`` equals JAX's
``model.apply``.

The same perturbed weights (made in JAX, carried into the port by
``compat/from_jax.py``) and the same numpy inputs go through both, uncached
and fed by one level of the timestep-level cache, for the BEAT preset
(unrolled and ``scan_layers`` layouts) and the SHOW preset with
classifier-free guidance (the batch doubles inside each branch).  f32:
rtol = atol = 1e-4 (the same layers in another summation order, through
two branches and the x0 bridge).  bf16: the port's bf16 forward against
JAX's f32 forward, rel-RMS <= 2.5e-2 (bench.py's bf16 band).  The
masked self-attention module on its own: 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diffsheg_tpu.models import level_cache as J  # noqa: E402
from diffsheg_tpu.models.unidiffuser import UniDiffuser as JU  # noqa: E402
from diffsheg_tpu_torch.models import level_cache as P  # noqa: E402
from torch_parity import (config_pair, jax_denoiser,  # noqa: E402
                          rel_rms, torch_denoiser)

LEVELS = np.array([0, 40, 480, 960], np.int32)
LEVEL = 2
SQRT_ALPHAS = (1.3, 0.8)


def _setup(preset, model, seed):
    jcfg, tcfg = config_pair(preset, model=model)
    variables = jax_denoiser(jcfg, seed=seed)
    m, T, B = jcfg.model, jcfg.data.n_poses, 2
    rng = np.random.RandomState(seed + 1)
    d = dict(x=rng.randn(B, T, m.motion_dim).astype(np.float32),
             mel=rng.randn(B, T, m.audio_dim).astype(np.float32),
             pid=np.eye(m.style_dim, dtype=np.float32)[[1, 2]],
             hub=rng.randn(B, T, m.hubert_dim).astype(np.float32),
             t=np.full((B,), LEVELS[LEVEL], np.int32))
    return jcfg, tcfg, variables, d


def _jax_forward(jcfg, variables, d, cached):
    jv = jax.tree.map(jnp.asarray, variables)
    a = {k: jnp.asarray(v) for k, v in d.items()}
    cache = None
    if cached:
        cache = J.gather_level(J.build_level_cache(
            jcfg.model, jv, jnp.asarray(LEVELS), a["mel"], a["pid"],
            a["hub"]), LEVEL)
    return np.asarray(JU(jcfg.model).apply(
        jv, a["x"], a["t"], SQRT_ALPHAS, a["mel"], a["pid"], hubert=a["hub"],
        train=False, cfg_inference=jcfg.model.uses_cfg_at_inference,
        cache=cache))


def _port_forward(tcfg, model, d, cached):
    a = {k: torch.tensor(v) for k, v in d.items()}
    cache = None
    if cached:
        cache = P.gather_level(P.build_level_cache(
            model, torch.tensor(LEVELS), a["mel"], a["pid"], a["hub"]), LEVEL)
    with torch.no_grad():
        return model(a["x"], a["t"], SQRT_ALPHAS, a["mel"], a["pid"],
                     hubert=a["hub"],
                     cfg_inference=tcfg.model.uses_cfg_at_inference,
                     cache=cache).numpy()


@pytest.mark.parametrize("preset,model,cached", [
    ("beat", {}, False), ("beat", {}, True),
    ("beat", {"scan_layers": True}, False),     # JAX caches unrolled only
    ("show", {}, False), ("show", {}, True)],
    ids=["beat_uncached", "beat_cached", "beat_scan_uncached",
         "show_cfg_uncached", "show_cfg_cached"])
def test_forward_matches_jax(preset, model, cached):
    jcfg, tcfg, variables, d = _setup(preset, model, seed=41)
    if preset == "show":
        assert jcfg.model.uses_cfg_at_inference
    ref = _jax_forward(jcfg, variables, d, cached)
    got = _port_forward(tcfg, torch_denoiser(tcfg, variables), d, cached)
    assert got.shape == ref.shape == d["x"].shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_cache_fed_forward_equals_uncached():
    # the cache holds exactly what the uncached forward computes per call
    _, tcfg, variables, d = _setup("beat", {}, seed=43)
    model = torch_denoiser(tcfg, variables)
    np.testing.assert_allclose(_port_forward(tcfg, model, d, True),
                               _port_forward(tcfg, model, d, False),
                               rtol=1e-5, atol=1e-5)


def test_bf16_forward_within_band_of_jax_f32():
    jcfg, tcfg, variables, d = _setup("beat", {}, seed=45)
    ref = _jax_forward(jcfg, variables, d, False)
    tcfg = tcfg.replace(model=dataclasses.replace(tcfg.model,
                                                  compute_dtype="bfloat16"))
    model = torch_denoiser(tcfg, variables).to(torch.bfloat16)
    got = _port_forward(tcfg, model, d, False)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert rel_rms(got, ref) <= 2.5e-2, rel_rms(got, ref)


def test_masked_self_attention_matches_jax():
    # the reference masking: key logits + (1 - mask) * -1e6 before the time
    # softmax, values zeroed outside the mask (no caller of the sampler
    # masks, so the module is checked on its own)
    from diffsheg_tpu.models.attention import LinearTemporalSelfAttention as JA
    from diffsheg_tpu_torch.compat.from_jax import load_flax_tree
    from diffsheg_tpu_torch.models.attention import (
        LinearTemporalSelfAttention as PA)
    from torch_parity import perturb
    B, T, L, E, H = 2, 34, 64, 256, 4
    rng = np.random.RandomState(47)
    x = rng.randn(B, T, L).astype(np.float32)
    emb = rng.randn(B, E).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    mask[0, 28:] = 0.0
    mask[1, 20:] = 0.0
    jm = JA(L, H)
    params = jm.init(jax.random.PRNGKey(48), jnp.asarray(x), jnp.asarray(emb),
                     jnp.asarray(mask))["params"]
    params = perturb(jax.tree.map(np.asarray, dict(params)), 49)
    ref = np.asarray(jm.apply({"params": jax.tree.map(jnp.asarray, params)},
                              jnp.asarray(x), jnp.asarray(emb),
                              jnp.asarray(mask)))
    pm = load_flax_tree(PA(L, H, E), {"params": params})
    with torch.no_grad():
        got = pm(torch.tensor(x), torch.tensor(emb), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
