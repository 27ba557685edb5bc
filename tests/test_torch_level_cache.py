"""Port parity: every field of the timestep-level cache equals JAX's.

The same perturbed weights (made in JAX, carried into the port by
``compat/from_jax.py``) and the same inputs go through
``diffsheg_tpu.models.level_cache`` and its port.  f32; tolerance 1e-5
(relative and absolute): the cache functions apply the same layers, only the
summation order differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diffsheg_tpu.models import level_cache as J  # noqa: E402
from diffsheg_tpu_torch.models import level_cache as P  # noqa: E402
from torch_parity import (config_pair, jax_denoiser,  # noqa: E402
                          torch_denoiser)


def _inputs(cfg, B, seed):
    rng = np.random.RandomState(seed)
    T, m = cfg.data.n_poses, cfg.model
    mel = rng.randn(B, T, m.audio_dim).astype(np.float32)
    pid = np.eye(m.style_dim, dtype=np.float32)[np.arange(B) % m.style_dim]
    hub = rng.randn(B, T, m.hubert_dim).astype(np.float32)
    return mel, pid, hub


def _close(got, ref):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model", [{}, {"expr_id_off": True},
                                   {"speech_encoder": "linear"}],
                         ids=["beat", "expr_id_off", "linear_hubert"])
def test_cache_fields_match(model):
    jcfg, tcfg = config_pair("beat", model=model)
    variables = jax_denoiser(jcfg, seed=3)
    jvars = jax.tree.map(jnp.asarray, variables)
    tmodel = torch_denoiser(tcfg, variables)
    levels = np.array([0, 40, 480, 960], np.int32)
    mel, pid, hub = _inputs(jcfg, 3, 4)

    js = J.build_static_cache(jcfg.model, jvars, jnp.asarray(levels),
                              jnp.asarray(pid))
    ts = P.build_static_cache(tmodel, torch.tensor(levels), torch.tensor(pid))
    _close(ts.exp_mods, js.exp_mods)
    _close(ts.ges_mods, js.ges_mods)

    ja = J.build_audio_cache(jcfg.model, jvars, jnp.asarray(levels),
                             jnp.asarray(mel), jnp.asarray(hub))
    ta = P.build_audio_cache(tmodel, torch.tensor(levels), torch.tensor(mel),
                             torch.tensor(hub))
    for field in J.AudioCache._fields:
        _close(getattr(ta, field), getattr(ja, field))

    jl = J.gather_level(J.combine(js, ja), 2)
    tl = P.gather_level(P.combine(ts, ta), 2)
    for branch in ("exp", "ges"):
        for field in J.BranchCache._fields:
            _close(getattr(getattr(tl, branch), field),
                   getattr(getattr(jl, branch), field))


def test_scan_layout_loads_the_same_weights():
    from diffsheg_tpu.models.factory import stack_scan_layers
    jcfg, tcfg = config_pair("beat")
    variables = jax_denoiser(jcfg, seed=5)
    stacked = dict(variables, params=jax.tree.map(
        np.asarray, stack_scan_layers(variables["params"], jcfg.model.num_layers)))
    assert "layers" in stacked["params"]["encoder_ges"]
    a = torch_denoiser(tcfg, variables).state_dict()
    b = torch_denoiser(tcfg, stacked).state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
