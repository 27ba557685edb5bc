"""Port parity: weight-only int8 / int4 serving (``diffusion.quantize``).

The port's ``quantize_layer_params`` gives JAX's codes bit for bit (int8
codes, nibble-packed int4 bytes) and its scales to 1 ulp; the quantized
plain versions of the fused-layer kernels (the ``sc`` branch of
``_layer_math``) agree with the JAX Pallas kernels run in interpret mode;
and one quantized window through ``WindowGenerator`` agrees with the JAX
generator on the same weights and replayed noise.  Tolerances: layer and
branch f32 atol = rtol = 2e-5, bf16 rel-RMS 1e-2 (as the unquantized tests:
sums in another order); the dequantization algebra 1e-5 (int8) and 1e-4
(int4), as the JAX package's own tests; a window rel-RMS 1e-4 (f32, DDIM
amplifies a random model's epsilon, see test_torch_sampler.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diffsheg_tpu.ops import fused_layer as J  # noqa: E402
from diffsheg_tpu_torch.ops import fused_layer as P  # noqa: E402
from test_torch_fused_layer import (B, H, L, T, arr, both, check,  # noqa: E402
                                    weights)
from torch_parity import (config_pair, jax_denoiser,  # noqa: E402
                          jax_window_noise, rel_rms, torch_denoiser)

BITS = {"int8": 8, "int4": 4}
DT = {"f32": torch.float32, "bf16": torch.bfloat16}
C_REAL, C_PAD = L + 35, 128


def quantize_both(w, dt, bits):
    """Each package quantizes its own copy of the same weights."""
    jlp, tlp = both(w, dt)
    return (J.quantize_layer_params(jlp, bits),
            P.quantize_layer_params(tlp, bits))


@pytest.mark.parametrize("quant,layout,dt", [
    ("int8", "layer", "f32"), ("int4", "layer", "f32"),
    ("int8", "stacked", "bf16"), ("int4", "stacked", "bf16")])
def test_quantize_matches_jax(quant, layout, dt):
    # bf16 weights are what the generator quantizes at bf16: both packages
    # cast the model first, then quantize f32 copies of bf16 values
    n = None if layout == "layer" else 3
    (jq, js), (tq, ts) = quantize_both(weights(C_REAL, C_PAD, 40, n=n), dt,
                                       BITS[quant])
    for name in J.LayerScales._fields:
        got, ref = getattr(tq, name), np.asarray(getattr(jq, name))
        assert got.dtype == torch.int8 and ref.dtype == np.int8
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
        s = getattr(ts, name)
        assert s.dtype == torch.float32 and s.shape == getattr(js, name).shape
        np.testing.assert_array_max_ulp(s.numpy(), np.asarray(getattr(js, name)),
                                        maxulp=1)
    for name in set(J.LayerParams._fields) - set(J.LayerScales._fields):
        # vectors keep their dtype and values
        assert getattr(tq, name).dtype == DT[dt]
        np.testing.assert_array_equal(
            getattr(tq, name).float().numpy(),
            np.asarray(jnp.asarray(getattr(jq, name), jnp.float32)))


def _layer_inputs(seed, dt):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, T, C_PAD).astype(np.float32)
    feats[..., C_REAL:] = 0.0
    return [arr(a, dt) for a in (
        rng.randn(B, T, L).astype(np.float32), feats,
        rng.randn(B, 2 * L).astype(np.float32),
        rng.randn(B, 2 * L).astype(np.float32))]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_layer_matches_pallas(quant, dt):
    (jq, js), (tq, ts) = quantize_both(weights(C_REAL, C_PAD, 41), dt,
                                       BITS[quant])
    x, f, ms, mf = _layer_inputs(42, dt)
    ref = J.fused_layer(x[0], f[0], ms[0], mf[0], jq, H, C_REAL, sc=js,
                        interpret=True)
    got = P.fused_layer(x[1], f[1], ms[1], mf[1], tq, H, C_REAL, sc=ts)
    assert got.dtype == x[1].dtype
    check(got, ref, dt)


@pytest.mark.parametrize("quant,null,dt", [
    ("int8", False, "f32"), ("int4", False, "f32"),
    ("int8", True, "f32"), ("int4", True, "f32"),
    ("int8", False, "bf16"), ("int4", True, "bf16")])
def test_quantized_branch_matches_pallas(quant, null, dt):
    n_layers = 2
    (jq, js), (tq, ts) = quantize_both(
        weights(C_REAL, C_PAD, 43, n=n_layers), dt, BITS[quant])
    rng = np.random.RandomState(44)
    cond = rng.randn(B, T, C_PAD - L).astype(np.float32)
    cond[..., C_REAL - L:] = 0.0
    x, c, m = (arr(a, dt) for a in (
        rng.randn(B, T, L).astype(np.float32), cond,
        rng.randn(n_layers, 2, B, 2 * L).astype(np.float32)))
    kw_j, kw_t = {}, {}
    if null:
        ne = rng.randn(1, C_PAD).astype(np.float32)
        ne[:, C_REAL:] = 0.0
        nm = np.array([1.0, 0.0], np.float32)    # first half unconditional
        kw_j = dict(null_emb=arr(ne, dt)[0], null_mask=jnp.asarray(nm))
        kw_t = dict(null_emb=arr(ne, dt)[1], null_mask=torch.tensor(nm))
    ref = J.fused_branch(x[0], c[0], m[0], jq, H, C_REAL, ssc=js,
                         interpret=True, **kw_j)
    got = P.fused_branch(x[1], c[1], m[1], tq, H, C_REAL, ssc=ts, **kw_t)
    check(got, ref, dt)


def _dequantized(tq, ts):
    """The codes times their scales as plain f32 matrices."""
    deq = {}
    for name in P.LayerScales._fields:
        q, s = getattr(tq, name), getattr(ts, name)
        if q.shape[-1] * 2 == s.shape[-1]:
            codes = torch.cat(P.unpack_int4(q), dim=-1)
        else:
            codes = q.float()
        deq[name] = codes * s[None]
    return tq._replace(**deq)


@pytest.mark.parametrize("quant,tol", [("int8", 1e-5), ("int4", 1e-4)])
def test_quantized_equals_explicit_dequant(quant, tol):
    # packing and the scaled product are exact algebra: all the
    # approximation is the rounding to codes
    tq, ts = P.quantize_layer_params(both(weights(C_REAL, C_PAD, 45), "f32")[1],
                                     BITS[quant])
    x, f, ms, mf = (t[1] for t in _layer_inputs(46, "f32"))
    got = P.fused_layer_reference(x, f, ms, mf, tq, H, C_REAL, sc=ts)
    ref = P.fused_layer_reference(x, f, ms, mf, _dequantized(tq, ts), H,
                                  C_REAL)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=tol, rtol=tol)


def test_int4_unpack_is_exact():
    # every byte a pair of codes in [-7, 7] can pack to
    hi, lo = np.meshgrid(np.arange(-7, 8), np.arange(-7, 8), indexing="ij")
    packed = ((hi << 4) | (lo & 0xF)).astype(np.int8).reshape(1, -1)
    uh, ul = P.unpack_int4(torch.tensor(packed))
    np.testing.assert_array_equal(uh.numpy(), hi.reshape(1, -1))
    np.testing.assert_array_equal(ul.numpy(), lo.reshape(1, -1))


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_chain_equals_per_layer(quant):
    n_layers = 3
    rng = np.random.RandomState(47)
    slq, ssc = P.quantize_layer_params(
        both(weights(C_REAL, C_PAD, 48, n=n_layers), "f32")[1], BITS[quant])
    x = torch.tensor(rng.randn(B, T, L).astype(np.float32))
    cond = torch.tensor(rng.randn(B, T, C_PAD - L).astype(np.float32))
    cond[..., C_REAL - L:] = 0.0
    mods = torch.tensor(rng.randn(n_layers, 2, B, 2 * L).astype(np.float32))
    chain = P.fused_branch(x, cond, mods, slq, H, C_REAL, ssc=ssc)
    h = x
    for i in range(n_layers):
        h = P.fused_layer(h, torch.cat([h, cond], -1), mods[i, 0], mods[i, 1],
                          P.layer_at(slq, i), H, C_REAL,
                          sc=P.layer_at(ssc, i))
    np.testing.assert_array_equal(chain.numpy(), h.numpy())


@pytest.mark.parametrize("quant,fused_layer", [("int8", "chain"),
                                               ("int4", "on")])
def test_quantized_window_matches_jax(quant, fused_layer):
    # one plain-program window (25 model calls) through each generator
    from diffsheg_tpu.sampling.generator import WindowGenerator as JGen
    from diffsheg_tpu_torch.diffusion.sampler import TableNoise
    from diffsheg_tpu_torch.sampling.generator import WindowGenerator as PGen
    jcfg, tcfg = config_pair("beat", diffusion=dict(quantize=quant,
                                                    fused_layer=fused_layer))
    variables = jax_denoiser(jcfg, seed=49)
    jgen = JGen(jcfg, jax.tree.map(jnp.asarray, variables))
    pgen = PGen(tcfg, torch_denoiser(tcfg, variables), device="cpu")
    assert jgen._use_fused_layer and pgen.use_fast
    m = jcfg.model
    B_, T_ = 1, jcfg.data.n_poses
    rng = np.random.RandomState(50)
    mel = rng.randn(B_, T_, m.audio_dim).astype(np.float32)
    pid = np.eye(m.style_dim, dtype=np.float32)[[2]]
    hub = rng.randn(B_, T_, m.hubert_dim).astype(np.float32)
    key = jax.random.PRNGKey(51)
    ref = np.asarray(jgen.generate(jnp.asarray(mel), jnp.asarray(pid), key,
                                   jnp.asarray(hub)))
    init, steps = jax_window_noise(key, B_, T_, m.motion_dim, jgen._plain,
                                   False)
    noise = TableNoise({0: init}, {(0, s, k): v for (s, k), v in steps.items()})
    got = pgen.generate(torch.tensor(mel), torch.tensor(pid), noise,
                        torch.tensor(hub)).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert rel_rms(got, ref) <= 1e-4, rel_rms(got, ref)


@pytest.mark.parametrize("over", [
    {"quantize": "int2"},
    {"quantize": "int8", "fused_layer": "off"},
    {"quantize": "int8", "level_cache": False},
    {"quantize": "int4", "respacing": "", "num_steps": 100},
], ids=["bad_value", "fused_layer_off", "no_level_cache", "100_steps"])
def test_quantize_validation(over):
    # the JAX generator's two rules: a known value, and the fast path
    from diffsheg_tpu_torch.models.unidiffuser import init_unidiffuser
    from diffsheg_tpu_torch.sampling.generator import WindowGenerator as PGen
    _, tcfg = config_pair("beat")
    cfg = tcfg.replace(diffusion=dataclasses.replace(tcfg.diffusion, **over))
    with pytest.raises(ValueError, match="quantize"):
        PGen(cfg, init_unidiffuser(cfg.model), device="cpu")


def _launch_args(quant, n=2):
    slq, ssc = P.quantize_layer_params(
        both(weights(C_REAL, C_PAD, 52, n=n), "f32")[1], BITS[quant])
    x = torch.zeros(B, T, L)
    mods = torch.zeros(n, 2, B, 2 * L)
    return dict(x=x, feats=torch.zeros(B, T, C_PAD - L), mod_sa=mods[0, 0],
                mod_ffn=mods[0, 1], mod_layer_stride=2 * B * 2 * L, slp=slq,
                n_layers=n, num_heads=H, c_real=C_REAL, chain=True,
                null_emb=None, null_mask=None, sc=ssc)


@pytest.mark.parametrize("fault,err", [
    ("scales_bf16", TypeError), ("int4_one_matrix_unpacked", ValueError),
    ("scales_not_layer_scales", TypeError), ("codes_f32", TypeError)])
def test_launch_refuses_malformed_quantized_weights(fault, err):
    # the wrapper's checks run before the kernel library is touched
    if fault == "scales_bf16":
        kw = _launch_args("int8")
        kw["sc"] = kw["sc"]._replace(q_k=kw["sc"].q_k.to(torch.bfloat16))
    elif fault == "int4_one_matrix_unpacked":
        kw = _launch_args("int4")
        kw["slp"] = kw["slp"]._replace(
            v_k=torch.zeros(2, L, L, dtype=torch.int8))
    elif fault == "scales_not_layer_scales":
        kw = _launch_args("int8")
        kw["sc"] = tuple(kw["sc"])
    else:
        kw = _launch_args("int8")
        kw["slp"] = kw["slp"]._replace(ffn_l1_k=kw["slp"].ffn_l1_k.float())
    with pytest.raises(err):
        P._launch(**kw)
