"""Port parity: the fast-path denoiser step equals JAX's.

``fast_unidiffuser_step`` (expression branch -> x0 bridge -> gesture
branch through the fused-layer kernels) on the same perturbed weights,
cache and inputs: JAX with the Pallas kernels in interpret mode, the port
with the kernels' plain versions (CPU).  Covers BEAT (no CFG) and SHOW
(classifier-free batch doubling with null rows), the per-layer and the
chain kernel, and weights carried from the unrolled and the
``scan_layers`` checkpoint layouts, unquantized and with int8 / int4
transformer stacks (``diffusion.quantize``, each package quantizing its
own copy), and models fed raw HuBERT features (``encode_hubert=False``:
the feats are wider by the HuBERT width, the layout whose full-width
branches run the kernel in K passes on the card).  f32; tolerance 1e-4
relative and absolute (two branches of stacked layers, summation order
differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diffsheg_tpu.models import fast_forward as JF  # noqa: E402
from diffsheg_tpu.models import level_cache as JC  # noqa: E402
from diffsheg_tpu_torch.models import fast_forward as PF  # noqa: E402
from diffsheg_tpu_torch.models import level_cache as PC  # noqa: E402
from torch_parity import (config_pair, jax_denoiser,  # noqa: E402
                          torch_denoiser)


@pytest.mark.parametrize("preset,chain,layout", [
    ("beat", False, "unrolled"), ("beat", True, "scan"),
    ("show", False, "scan"), ("show", True, "unrolled")])
def test_fast_step_matches_jax(preset, chain, layout):
    _check_fast_step(preset, chain, layout, "none")


@pytest.mark.parametrize("preset,chain,layout,quant", [
    ("beat", True, "unrolled", "int8"), ("show", False, "scan", "int4")])
def test_quantized_fast_step_matches_jax(preset, chain, layout, quant):
    _check_fast_step(preset, chain, layout, quant)


@pytest.mark.parametrize("preset,chain", [
    ("beat", False), ("beat", True), ("show", False), ("show", True)])
def test_raw_hubert_fast_step_matches_jax(preset, chain):
    # the raw HuBERT features join the condition (hubert_dim 48: c_real is
    # no multiple of 128, so the padded feats take the masked LayerNorm).
    # SHOW without classifier-free guidance: JAX sizes its null row for the
    # encoded features (test_jax_raw_hubert_null_row_is_narrow)
    model = dict(encode_hubert=False)
    if preset == "show":
        model["classifier_free"] = False
    _check_fast_step(preset, chain, "unrolled", "none", model=model)


def test_jax_raw_hubert_null_row_is_narrow():
    # a fault of the JAX reference that the port does not copy: with raw
    # HuBERT features its pre_proj_dim (diffsheg_tpu/models/denoiser.py
    # :169-179) still counts hubert_latent_dim, so the classifier-free null
    # row is hubert_dim - hubert_latent_dim narrower than the feats it
    # replaces; the port's row has the feats' width (the reference
    # checkpoint layout, compat/torch_ckpt.py)
    jcfg, tcfg = config_pair("show", model=dict(encode_hubert=False),
                             data={"n_poses": 24})
    from diffsheg_tpu_torch.models.factory import build_denoiser
    m = jcfg.model
    c_real = PF.branch_feats_dim(tcfg.model, 0)
    assert c_real == m.latent_dim + m.aud_latent_dim + m.hubert_dim
    jnull = jax_denoiser(jcfg, seed=11)["params"]["encoder_exp"][
        "null_cond_emb"]
    tnull = build_denoiser(tcfg.model).encoder_exp.null_cond_emb
    assert tnull.shape == (1, c_real)
    assert jnull.shape == (1, c_real - m.hubert_dim + m.hubert_latent_dim)


def _check_fast_step(preset, chain, layout, quant, model=None):
    from diffsheg_tpu.models.factory import stack_scan_layers
    # SHOW's 88-frame window trimmed to 24 frames keeps the test cheap;
    # classifier-free guidance (cond_scale 1.15) stays on
    data = {"n_poses": 24} if preset == "show" else {}
    jcfg, tcfg = config_pair(preset, model=model, data=data)
    m = jcfg.model
    B, T = 2, jcfg.data.n_poses
    variables = jax_denoiser(jcfg, seed=11)
    jvars = jax.tree.map(jnp.asarray, variables)
    tvars = variables
    if layout == "scan":
        tvars = dict(variables, params=jax.tree.map(
            np.asarray, stack_scan_layers(variables["params"], m.num_layers)))
    tmodel = torch_denoiser(tcfg, tvars)

    rng = np.random.RandomState(12)
    mel = rng.randn(B, T, m.audio_dim).astype(np.float32)
    pid = np.eye(m.style_dim, dtype=np.float32)[[1, 2]]
    hub = rng.randn(B, T, m.hubert_dim).astype(np.float32)
    x = rng.randn(B, T, m.motion_dim).astype(np.float32)
    levels = np.array([0, 480, 960], np.int32)
    sr, srm1 = 1.7, 0.9

    jcache = JC.gather_level(JC.build_level_cache(
        m, jvars, jnp.asarray(levels), jnp.asarray(mel), jnp.asarray(pid),
        jnp.asarray(hub)), 1)
    jfp = JF.extract_fast_params(m, jvars, T, True, quant=quant)
    # one jitted call: interpret-mode Pallas dispatched eagerly is slow
    ref = jax.jit(lambda fp, xx, c: JF.fast_unidiffuser_step(
        m, fp, xx, (jnp.full((B, 1, 1), sr), jnp.full((B, 1, 1), srm1)), c,
        cfg_inference=m.uses_cfg_at_inference, interpret=True,
        chain=chain))(jfp, jnp.asarray(x), jcache)

    tcache = PC.gather_level(PC.build_level_cache(
        tmodel, torch.tensor(levels), torch.tensor(mel), torch.tensor(pid),
        torch.tensor(hub)), 1)
    tfp = PF.extract_fast_params(tcfg.model, tmodel, T, quant=quant)
    assert (tfp.ges.scales is None) == (quant == "none")
    got = PF.fast_unidiffuser_step(tcfg.model, tfp, torch.tensor(x),
                                   (sr, srm1), tcache,
                                   cfg_inference=m.uses_cfg_at_inference,
                                   chain=chain)
    assert got.shape == (B, T, m.motion_dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
