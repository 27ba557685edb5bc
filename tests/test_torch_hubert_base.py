"""Port parity: the HuBERT-base / wav2vec2-base layout.

The layout: bias-free convs, a per-channel GroupNorm over time on the
first conv only (``conv_norm='group_first'``; its statistics over every
time step, a padded row's pad samples included, as in JAX), the encoder
LayerNorm after the positional conv and post-LN layers
(``stable_layer_norm=False``).

- a tiny model of that layout, weights made in JAX and carried over,
  against JAX's forward, padded rows masked (f32 rel-RMS <= 1e-5);
- ``convert_hubert_state_dict`` on a HuggingFace state dict of that
  layout built in the test: equal to JAX's conversion key for key, and
  the converted model within 1e-5 of HF's own forward;
- the chunked extractor on a padded remainder chunk against JAX's;
- the presets equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import perturb, rel_rms  # noqa: E402

TINY = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=48,
            conv_dim=(8,) * 7, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4, conv_norm="group_first",
            conv_bias=False, stable_layer_norm=False)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _jax_model(seed, **over):
    from diffsheg_tpu.models.hubert import HubertConfig, HubertModel
    cfg = HubertConfig(**dict(TINY, **over))
    model = HubertModel(cfg)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1600)))
    return model, perturb(jax.tree.map(np.asarray, dict(variables)), seed + 1)


def _port_model(variables, **over):
    from diffsheg_tpu_torch.compat.from_jax import load_flax_tree
    from diffsheg_tpu_torch.models.hubert import HubertConfig, HubertModel
    return load_flax_tree(HubertModel(HubertConfig(**dict(TINY, **over))),
                          variables).eval()


def _wave(B, n, seed):
    return np.random.RandomState(seed).randn(B, n).astype(np.float32) * 0.3


@pytest.mark.parametrize("masked", [False, True], ids=["full", "padded"])
def test_base_layout_forward_matches_jax(masked):
    jm, variables = _jax_model(0)
    pm = _port_model(variables)
    assert not any("ln_" in k for k, _ in _leaves(variables)
                   if "feature_extractor" in k)
    assert pm.feature_extractor.conv_0.bias is None
    x = _wave(2, 8000, 1)
    mask = None
    if masked:
        # row 1 is right-padded: its last 10 conv frames are pad
        T = (8000 - 400) // 320 + 1
        x[1, -3200:] = 0.0
        mask = np.arange(T)[None, :] < np.asarray([[T], [T - 10]])
    ref = np.asarray(jax.jit(jm.apply)(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x),
        None if mask is None else jnp.asarray(mask)))
    with torch.no_grad():
        got = pm(torch.tensor(x),
                 None if mask is None else torch.tensor(mask)).numpy()
    assert got.shape == ref.shape == (2, 24, TINY["hidden_size"])
    assert np.isfinite(got).all()
    assert rel_rms(got, ref) <= 1e-5
    if masked:   # the valid frames of the padded row only
        assert rel_rms(got[1, :14], ref[1, :14]) <= 1e-5


def test_large_and_base_layouts_differ_only_where_they_should():
    # the same weights through pre-LN and post-LN give different outputs;
    # the pre-LN port still matches JAX (its own tests hold the rest)
    over = dict(conv_norm="layer", stable_layer_norm=True, conv_bias=True)
    jm, variables = _jax_model(3, **over)
    pm = _port_model(variables, **over)
    x = _wave(1, 4000, 4)
    ref = np.asarray(jax.jit(jm.apply)(jax.tree.map(jnp.asarray, variables),
                                       jnp.asarray(x)))
    with torch.no_grad():
        got = pm(torch.tensor(x)).numpy()
    assert rel_rms(got, ref) <= 1e-5


def _hf_base(seed=0):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(seed)
    cfg = transformers.HubertConfig(
        hidden_size=TINY["hidden_size"], num_hidden_layers=TINY["num_layers"],
        num_attention_heads=TINY["num_heads"],
        intermediate_size=TINY["intermediate_size"],
        conv_dim=TINY["conv_dim"], conv_kernel=(10, 3, 3, 3, 3, 2, 2),
        conv_stride=(5, 2, 2, 2, 2, 2, 2),
        num_conv_pos_embeddings=TINY["num_conv_pos_embeddings"],
        num_conv_pos_embedding_groups=TINY["num_conv_pos_embedding_groups"],
        conv_bias=False, do_stable_layer_norm=False,
        feat_extract_norm="group", hidden_act="gelu",
        feat_proj_layer_norm=True)
    model = transformers.HubertModel(cfg).eval()
    with torch.no_grad():     # no zero or unit leaf hides a sub-layer
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return model


def test_convert_base_state_dict_matches_jax_and_hf():
    from diffsheg_tpu.compat.hubert_ckpt import convert_hubert_state_dict as jconv
    from diffsheg_tpu.models.hubert import HubertConfig as JC
    from diffsheg_tpu_torch.compat.from_jax import load_flax_tree
    from diffsheg_tpu_torch.compat.hubert_ckpt import convert_hubert_state_dict
    from diffsheg_tpu_torch.models.hubert import HubertConfig, HubertModel
    hf = _hf_base()
    sd = hf.state_dict()
    assert "feature_extractor.conv_layers.0.layer_norm.weight" in sd
    assert "feature_extractor.conv_layers.1.layer_norm.weight" not in sd
    tree = convert_hubert_state_dict(sd, HubertConfig(**TINY))
    want = dict(_leaves(jconv(sd, JC(**TINY))))
    got = dict(_leaves(tree))
    assert got.keys() == want.keys()
    assert "/params/feature_extractor/gn_scale" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    port = load_flax_tree(HubertModel(HubertConfig(**TINY)), tree).eval()
    x = torch.tensor(_wave(2, 8000, 5))
    with torch.no_grad():
        ref = hf(x).last_hidden_state
        out = port(x)
    assert out.shape == ref.shape
    assert rel_rms(out.numpy(), ref.numpy()) <= 1e-5


def test_load_hf_base_from_local_file(tmp_path):
    from diffsheg_tpu_torch.compat.hubert_ckpt import load_hf_hubert
    from diffsheg_tpu_torch.models.hubert import HubertConfig
    hf = _hf_base(seed=1)
    sd = {"hubert." + k: v.contiguous() for k, v in hf.state_dict().items()}
    torch.save(sd, tmp_path / "pytorch_model.bin")
    port = load_hf_hubert(str(tmp_path), HubertConfig(**TINY))
    assert torch.equal(port.feature_extractor.gn_scale,
                       sd["hubert.feature_extractor.conv_layers.0.layer_norm.weight"])
    x = torch.tensor(_wave(1, 4000, 6))
    with torch.no_grad():
        assert rel_rms(port(x).numpy(),
                       hf(x).last_hidden_state.numpy()) <= 1e-5


def test_extractor_with_base_layout_matches_jax():
    from diffsheg_tpu.audio.hubert_runner import HubertFeatureExtractor as JH
    from diffsheg_tpu.models.hubert import HubertConfig as JC
    from diffsheg_tpu_torch.audio.hubert_runner import (
        CLIP_SAMPLES, HubertFeatureExtractor as PH, expected_frames)
    _, variables = _jax_model(7)
    jh = JH(JC(**TINY), variables=jax.tree.map(jnp.asarray, variables))
    ph = PH(model=_port_model(variables), device="cpu")
    # a padded, masked remainder; at the encoder's own frame rate (the
    # motion-rate resample's f32 positions may round one ulp apart between
    # the packages, test_torch_pipeline.py holds it on its own)
    audio = _wave(1, CLIP_SAMPLES + 8000, 8)
    ref = np.asarray(jh(jnp.asarray(audio)))
    got = ph(torch.tensor(audio)).numpy()
    assert got.shape == ref.shape == (1, expected_frames(audio.shape[1]),
                                      TINY["hidden_size"])
    assert rel_rms(got, ref) <= 1e-5


def port_only_off(cfg):
    """``cfg`` as a dict of JAX's fields, after checking that the port's
    own field (WavLM's relative-position bias) is off, as in every JAX
    layout."""
    import dataclasses
    d = dataclasses.asdict(cfg)
    assert d.pop("rel_pos_buckets") == 0
    return d


def test_presets_equal_jax():
    import dataclasses
    import diffsheg_tpu.models.hubert as J
    import diffsheg_tpu_torch.models.hubert as P
    assert port_only_off(P.wav2vec2_base_config()) == dataclasses.asdict(
        J.wav2vec2_base_config())
    assert port_only_off(P.HubertConfig()) == dataclasses.asdict(
        J.hubert_large_config())
    base = P.HubertModel(P.HubertConfig(**dict(TINY, hidden_size=24,
                                               num_heads=2)))
    names = {n for n, _ in base.named_parameters()}
    assert "feature_extractor.gn_scale" in names
    assert not any(n.startswith("feature_extractor.ln_") for n in names)
