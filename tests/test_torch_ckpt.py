"""The port's checkpoint loaders against the JAX package's.

- DiffSHEG reference state dicts (``compat/torch_ckpt.py``): JAX variables
  exported by the JAX package load into the port's ``UniDiffuser`` with
  every parameter and buffer bit-equal to ``load_flax_tree`` of the same
  variables; the port's export equals JAX's key for key; the expected
  keys agree; a ``.tar`` round trip is exact, and the JAX loader reads
  the port's ``.tar`` back to the original variables; the same for the
  decoder base (its ``ca_block`` cross-attentions, ``text_norm`` included),
  and both exports refuse what has no reference layout.
- HuggingFace HuBERT (``compat/hubert_ckpt.py``): a tiny
  ``transformers.HubertModel`` (HuBERT-large layout, random weights, built
  from a config here; nothing is downloaded) converts to the same tree as
  the JAX converter, and the port's forward matches HF's (f32, 1e-5
  relative); the weight-norm names of both torch generations fold alike;
  the HuBERT-base layout raises.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (config_pair, jax_denoiser,  # noqa: E402
                          torch_denoiser)

MODELS = {"conv-hubert": {},
          "cfg-no-hubert": dict(add_hubert=False, classifier_free=True),
          "linear-speech": dict(speech_encoder="linear")}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _assert_same_module(a, b):
    sa = dict(list(a.named_parameters()) + list(a.named_buffers()))
    sb = dict(list(b.named_parameters()) + list(b.named_buffers()))
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.fixture(scope="module", params=list(MODELS), ids=list(MODELS))
def model_pair(request):
    jcfg, tcfg = config_pair(model=MODELS[request.param])
    variables = jax_denoiser(jcfg, 3)
    return jcfg, tcfg, variables, torch_denoiser(tcfg, variables)


def test_reference_state_dict_loads_bit_equal(model_pair):
    from diffsheg_tpu.compat.torch_ckpt import export_unidiffuser_state_dict
    from diffsheg_tpu_torch.compat.from_jax import load_flax_tree
    from diffsheg_tpu_torch.compat.torch_ckpt import \
        convert_unidiffuser_state_dict
    from diffsheg_tpu_torch.models.unidiffuser import UniDiffuser
    _, tcfg, variables, ref = model_pair
    sd = {f"module.{k}": torch.from_numpy(np.array(v))
          for k, v in export_unidiffuser_state_dict(variables).items()}
    got = load_flax_tree(UniDiffuser(tcfg.model),
                         convert_unidiffuser_state_dict(sd, tcfg.model))
    _assert_same_module(got, ref)


def test_export_matches_jax_and_expected_keys(model_pair):
    from diffsheg_tpu.compat.torch_ckpt import (
        expected_reference_keys as jkeys, export_unidiffuser_state_dict as jexp)
    from diffsheg_tpu_torch.compat.torch_ckpt import (
        expected_reference_keys, export_unidiffuser_state_dict)
    jcfg, tcfg, variables, model = model_pair
    got, want = export_unidiffuser_state_dict(model), jexp(variables)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    keys = expected_reference_keys(tcfg.model)
    assert keys == jkeys(jcfg.model)
    assert keys == {k: v.shape for k, v in got.items()}


def test_tar_round_trip(model_pair, tmp_path):
    from diffsheg_tpu.compat.torch_ckpt import load_reference_checkpoint as jload
    from diffsheg_tpu_torch.compat.torch_ckpt import (
        load_reference_checkpoint, save_reference_checkpoint)
    jcfg, tcfg, variables, model = model_pair
    path = save_reference_checkpoint(model, str(tmp_path / "m.tar"), epoch=3)
    assert torch.load(path, weights_only=True)["ep"] == 3
    _assert_same_module(load_reference_checkpoint(path, tcfg.model), model)
    back = dict(_leaves(jax.tree.map(np.asarray, jload(path, jcfg.model))))
    for name, leaf in _leaves(variables):
        np.testing.assert_array_equal(back[name], leaf, err_msg=name)


@pytest.mark.parametrize("model", [
    dict(model_base="transformer_decoder"),
    dict(model_base="transformer_decoder", classifier_free=True,
         learned_variance=True, add_hubert=False)],
    ids=["decoder", "decoder-cfg-learned-var"])
def test_decoder_reference_layout_round_trip(model, tmp_path):
    from diffsheg_tpu.compat.torch_ckpt import (
        export_unidiffuser_state_dict as jexp,
        load_reference_checkpoint as jload)
    from diffsheg_tpu_torch.compat.from_jax import load_flax_tree
    from diffsheg_tpu_torch.compat.torch_ckpt import (
        convert_unidiffuser_state_dict, expected_reference_keys,
        export_unidiffuser_state_dict, load_reference_checkpoint,
        save_reference_checkpoint)
    from diffsheg_tpu_torch.models.unidiffuser import UniDiffuser
    jcfg, tcfg = config_pair(model=model)
    variables = jax_denoiser(jcfg, 5)
    ported = torch_denoiser(tcfg, variables)
    got, want = export_unidiffuser_state_dict(ported), jexp(variables)
    assert got.keys() == want.keys()
    assert any(".ca_block.text_norm." in k for k in want)
    assert not any(".feat_proj." in k for k in want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert expected_reference_keys(tcfg.model) == {k: v.shape
                                                   for k, v in want.items()}
    sd = {k: torch.from_numpy(np.array(v)) for k, v in want.items()}
    _assert_same_module(load_flax_tree(
        UniDiffuser(tcfg.model),
        convert_unidiffuser_state_dict(sd, tcfg.model)), ported)
    path = save_reference_checkpoint(ported, str(tmp_path / "d.tar"))
    _assert_same_module(load_reference_checkpoint(path, tcfg.model), ported)
    back = dict(_leaves(jax.tree.map(np.asarray, jload(path, jcfg.model))))
    for name, leaf in _leaves(variables):
        np.testing.assert_array_equal(back[name], leaf, err_msg=name)


@pytest.mark.parametrize("model", [dict(branch_mode="gesture_only"),
                                   dict(add_text_cond=True, word_vocab=20)],
                         ids=["single-branch", "text"])
def test_export_refuses_what_jax_refuses(model):
    from diffsheg_tpu.compat.torch_ckpt import (
        export_unidiffuser_state_dict as jexp)
    from diffsheg_tpu_torch.compat.torch_ckpt import (
        export_unidiffuser_state_dict)
    jcfg, tcfg = config_pair(model=dict(model, add_hubert=False))
    variables = jax_denoiser(jcfg, 6)
    with pytest.raises(ValueError, match="cannot export"):
        jexp(variables)
    with pytest.raises(ValueError, match="cannot export"):
        export_unidiffuser_state_dict(torch_denoiser(tcfg, variables))


# -- HuggingFace HuBERT ------------------------------------------------------

HUB = dict(hidden_size=48, num_layers=2, num_heads=2, intermediate_size=64,
           conv_dim=(8,) * 7, num_conv_pos_embeddings=16,
           num_conv_pos_embedding_groups=4)


def _hf(layout="large", seed=0):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(seed)
    large = layout == "large"
    cfg = transformers.HubertConfig(
        hidden_size=HUB["hidden_size"], num_hidden_layers=HUB["num_layers"],
        num_attention_heads=HUB["num_heads"],
        intermediate_size=HUB["intermediate_size"], conv_dim=HUB["conv_dim"],
        conv_kernel=(10, 3, 3, 3, 3, 2, 2), conv_stride=(5, 2, 2, 2, 2, 2, 2),
        num_conv_pos_embeddings=HUB["num_conv_pos_embeddings"],
        num_conv_pos_embedding_groups=HUB["num_conv_pos_embedding_groups"],
        conv_bias=True, do_stable_layer_norm=large,
        feat_extract_norm="layer" if large else "group",
        hidden_act="gelu", feat_proj_layer_norm=True)
    model = transformers.HubertModel(cfg).eval()
    with torch.no_grad():     # no zero or unit leaf hides a sub-layer
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return model


def _port_cfg():
    from diffsheg_tpu_torch.models.hubert import HubertConfig
    return HubertConfig(**HUB)


def test_hf_hubert_forward_and_jax_converter():
    from diffsheg_tpu.compat.hubert_ckpt import convert_hubert_state_dict as jconv
    from diffsheg_tpu.models.hubert import HubertConfig as JC
    from diffsheg_tpu_torch.compat.from_jax import load_flax_tree
    from diffsheg_tpu_torch.compat.hubert_ckpt import convert_hubert_state_dict
    from diffsheg_tpu_torch.models.hubert import HubertModel
    hf = _hf()
    sd = hf.state_dict()
    assert any("parametrizations.weight.original0" in k for k in sd)
    tree = convert_hubert_state_dict(sd, _port_cfg())
    want = dict(_leaves(jconv(sd, JC(**HUB))))
    got = dict(_leaves(tree))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    port = load_flax_tree(HubertModel(_port_cfg()), tree).eval()
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 8000)
                         .astype(np.float32))
    with torch.no_grad():
        ref = hf(x).last_hidden_state
        out = port(x)
    assert out.shape == ref.shape
    rel = float((out - ref).norm() / ref.norm())
    assert rel <= 1e-5, rel


def test_hf_hubert_legacy_weight_norm_names_and_prefix():
    from diffsheg_tpu_torch.compat.hubert_ckpt import convert_hubert_state_dict
    sd = _hf().state_dict()
    new = convert_hubert_state_dict(sd, _port_cfg())
    p = "encoder.pos_conv_embed.conv"
    legacy = {("hubert." + k).replace(f"{p}.parametrizations.weight.original0",
                                      f"{p}.weight_g")
              .replace(f"{p}.parametrizations.weight.original1",
                       f"{p}.weight_v"): v for k, v in sd.items()}
    old = convert_hubert_state_dict(legacy, _port_cfg())
    for (ka, a), (kb, b) in zip(_leaves(new), _leaves(old)):
        assert ka == kb
        np.testing.assert_array_equal(a, b, err_msg=ka)


@pytest.mark.parametrize("fmt", ["pytorch_model.bin", "model.safetensors"])
def test_load_hf_hubert_from_local_files(fmt, tmp_path):
    from diffsheg_tpu_torch.compat.hubert_ckpt import load_hf_hubert
    hf = _hf(seed=2)
    sd = {k: v.contiguous() for k, v in hf.state_dict().items()}
    if fmt.endswith(".safetensors"):
        st = pytest.importorskip("safetensors.torch")
        st.save_file(sd, str(tmp_path / fmt))
    else:
        torch.save(sd, tmp_path / fmt)
    for path in (tmp_path, tmp_path / fmt):
        port = load_hf_hubert(str(path), _port_cfg())
        assert torch.equal(port.final_ln.weight, sd["encoder.layer_norm.weight"])
    with pytest.raises(FileNotFoundError, match="not a local file"):
        load_hf_hubert("facebook/hubert-large-ls960-ft")


def test_hubert_base_layout_raises():
    # the HuBERT-base layout was refused; it now converts, key for key as
    # JAX converts it, and the model matches HF's forward
    # (tests/test_torch_hubert_base.py holds it against JAX)
    import dataclasses
    from diffsheg_tpu.compat.hubert_ckpt import convert_hubert_state_dict as jconv
    from diffsheg_tpu.models.hubert import HubertConfig as JC
    from diffsheg_tpu_torch.compat.from_jax import load_flax_tree
    from diffsheg_tpu_torch.compat.hubert_ckpt import convert_hubert_state_dict
    from diffsheg_tpu_torch.models.hubert import HubertModel
    hf = _hf(layout="base")
    sd = hf.state_dict()
    base = dict(conv_norm="group_first", stable_layer_norm=False)
    cfg = dataclasses.replace(_port_cfg(), **base)
    tree = convert_hubert_state_dict(sd, cfg)
    want = dict(_leaves(jconv(sd, JC(**HUB, **base))))
    got = dict(_leaves(tree))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    port = load_flax_tree(HubertModel(cfg), tree).eval()
    x = torch.from_numpy(np.random.RandomState(3).randn(1, 8000)
                         .astype(np.float32))
    with torch.no_grad():
        ref = hf(x).last_hidden_state
        out = port(x)
    assert float((out - ref).norm() / ref.norm()) <= 1e-5
