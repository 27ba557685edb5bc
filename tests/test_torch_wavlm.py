"""WavLM-Large in the port (``models/hubert.py``: ``wavlm_large_config``,
``GatedRelPosAttention``; ``compat/hubert_ckpt.py``; the entry points'
``--speech-encoder``) against the benchmark's plain reference
(``benchmark/reference/wavlm.py``) on seeded random weights, on the CPU.

- the relative-position buckets, exact against a table written by hand;
- the encoder at a small width (hidden 64, 4 heads, 2 layers) with
  WavLM's 320 buckets and distance 800 over 850 frames (exact, log and
  capped buckets all occur), a padded row included: rel-RMS <= 1e-5, the
  same f32 arithmetic on both sides in another order (observed 0 to
  1e-7); the ungated control (the gate held at 1) fails that tolerance by
  three orders of magnitude or more;
- against HuggingFace's ``WavLMModel`` where ``transformers`` is present;
- one training step with the on-device frontend and WavLM at the
  benchmark's tiny widths against the reference step;
- a ``WavLMModel``-named state dict loaded by ``compat/hubert_ckpt.py``;
- the long-audio runner and ``cli train`` / ``cli generate`` selecting
  WavLM by settings alone;
- HuBERT-large and wav2vec2-base keep today's attention.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import rel_rms

from benchmark import program, weights
from benchmark.reference import speech as ref_speech
from benchmark.reference import wavlm as ref_wavlm
from diffsheg_tpu_torch.models import hubert
from diffsheg_tpu_torch.models.hubert import (HubertConfig, HubertModel,
                                              relative_position_buckets,
                                              wavlm_large_config)

SMALL = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
             conv_dim=[16] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
             conv_stride=[5, 2, 2, 2, 2, 2, 2], num_conv_pos_embeddings=16,
             num_conv_pos_embedding_groups=4, conv_norm="layer",
             conv_bias=False, stable_layer_norm=True, rel_pos_buckets=320)
# same f32 arithmetic in another order on both sides: rounding only
TOL = 1e-5

# r = j - i -> bucket: each sign half of 320; |r| < 80 exact; past it
# 80 + floor(log(|r| / 80) / log(10) * 80), capped at 159; r > 0 + 160
BUCKETS = {0: 0, 1: 161, -1: 1, 79: 239, -79: 79, 80: 240, -80: 80,
           81: 240, -81: 80, 500: 303, -500: 143, 799: 319, -799: 159,
           800: 319, -800: 159, 2000: 319, -2000: 159}


@pytest.mark.parametrize("r", sorted(BUCKETS))
def test_bucket_table_exact(r):
    assert ref_wavlm.bucket(r, 320, 800) == BUCKETS[r]
    T = 2001
    i = 0 if r >= 0 else T - 1
    table = relative_position_buckets(T, 320, 800)
    assert int(table[i, i + r]) == BUCKETS[r]


def small_pair(seed=3):
    """(reference, port) on the benchmark's seeded weights of SMALL."""
    from benchmark.traffic.train_frontend import encoder_state
    state = encoder_state({"hubert": SMALL}, seed, "cpu")
    ref = weights.build(ref_wavlm.WavLM, SMALL, state=state,
                        device="cpu").eval()
    port = HubertModel(program.hubert_config({"hubert": SMALL},
                                             "float32")).eval()
    port.load_state_dict({k: v for k, v in state.items()
                          if k in port.state_dict()}, strict=True)
    return ref, port


def small_input(T=850, valid=600, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((2, (T - 1) * 320 + 400), generator=g)
    mask = torch.ones((2, T), dtype=torch.bool)
    mask[1, valid:] = False
    return x, mask


def test_features_match_the_reference_over_every_bucket_kind():
    ref, port = small_pair()
    x, mask = small_input()
    with torch.no_grad():
        a, b = ref(x, mask), port(x, mask)
    # frames 0..849: exact (< 80), log (80..799) and capped (800+) buckets
    assert a.shape == b.shape == (2, 850, 64)
    assert rel_rms(b[0].numpy(), a[0].numpy()) <= TOL
    assert rel_rms(b[1, :600].numpy(), a[1, :600].numpy()) <= TOL


def test_padded_keys_get_zero_weight():
    _, port = small_pair()
    x, mask = small_input()
    with torch.no_grad():
        full = port(x, mask)[1, :600]
        alone = port(x[1:, :599 * 320 + 400], mask[1:, :600])[0]
    assert rel_rms(full.numpy(), alone.numpy()) <= TOL


def test_the_ungated_control_fails_the_tolerance(monkeypatch):
    # the fault the control plants: the bias added with the gate held at 1
    monkeypatch.setattr(hubert.GatedRelPosAttention, "bias",
                        lambda self, x, position_bias: position_bias)
    ref, port = small_pair()
    x, mask = small_input()
    with torch.no_grad():
        a, b = ref(x, mask), port(x, mask)
    assert rel_rms(b[0].numpy(), a[0].numpy()) > 1e3 * TOL


def test_port_matches_transformers_wavlm():
    transformers = pytest.importorskip("transformers")
    from diffsheg_tpu_torch.compat.hubert_ckpt import convert_hubert_state_dict
    from diffsheg_tpu_torch.compat.from_jax import load_flax_tree
    torch.manual_seed(0)
    hc = transformers.WavLMConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, conv_dim=(16,) * 7, feat_extract_norm="layer",
        do_stable_layer_norm=True, conv_bias=False,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        feat_proj_dropout=0.0, layerdrop=0.0)
    hf = transformers.WavLMModel(hc).eval()
    with torch.no_grad():
        for n, p in hf.named_parameters():
            if "rel_attn_embed" in n or "gru_rel_pos_const" in n:
                p.normal_(0.0, 1.0)
            elif "gru_rel_pos_linear" in n:
                p.normal_(0.0, 0.3)
    cfg = HubertConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in SMALL.items()})
    port = load_flax_tree(HubertModel(cfg),
                          convert_hubert_state_dict(hf.state_dict(), cfg))
    x, _ = small_input(T=820)
    with torch.no_grad():
        a = hf(x).last_hidden_state
        b = port.eval()(x)
    assert rel_rms(b.numpy(), a.numpy()) <= TOL


def test_one_frontend_training_step_matches_the_reference():
    """The benchmark's frontend cell at its tiny widths on the CPU: the
    first step's features, and three steps' loss, first gradient and
    change against the reference fed the reference's features (f32 on both
    sides: rounding)."""
    from benchmark.tests.tiny import dry_run
    res = dry_run("beat-wavlm-train-fe-f32")
    c = res["checks"]
    assert res["correct"]
    assert c["encoder_window_rel_rms"]["value"] < TOL
    assert c["loss_rel_gap"]["value"] < 1e-5
    assert c["first_grad_leaf_gap"]["value"] < 1e-5
    assert c["change_leaf_gap"]["value"] < 1e-4


def hf_named(model, prefix=""):
    """``model``'s weights under HuggingFace ``WavLMModel`` names as a
    published checkpoint holds them: the positional conv weight-normed
    (``weight_g`` / ``weight_v``), the gate constants (1, heads, 1, 1),
    ``masked_spec_embed`` beside them."""
    from diffsheg_tpu_torch.compat.hubert_ckpt import hf_state_dict
    sd = hf_state_dict(model)
    w = sd.pop("encoder.pos_conv_embed.conv.weight")
    g = w.norm(dim=(0, 1), keepdim=True)
    sd["encoder.pos_conv_embed.conv.weight_g"] = g
    sd["encoder.pos_conv_embed.conv.weight_v"] = w / g * 3.0
    sd["masked_spec_embed"] = torch.rand(model.cfg.hidden_size)
    assert sd["encoder.layers.1.attention.gru_rel_pos_const"].shape == (
        1, model.cfg.num_heads, 1, 1)
    assert "encoder.layers.0.attention.rel_attn_embed.weight" in sd
    assert not any(k.endswith("conv.bias") and "feature_extractor" in k
                   for k in sd)
    return {prefix + k: v for k, v in sd.items()}


@pytest.mark.parametrize("prefix", ["", "wavlm."])
def test_load_a_wavlm_state_dict(tmp_path, prefix):
    """A ``WavLMModel`` (or ``WavLMForCTC``, ``wavlm.``) state dict in a
    checkpoint directory, in the layout given."""
    from diffsheg_tpu_torch.compat.hubert_ckpt import load_hf_hubert
    _, port = small_pair()
    torch.save(hf_named(port, prefix), tmp_path / "pytorch_model.bin")
    loaded = load_hf_hubert(str(tmp_path), port.cfg)
    assert loaded.cfg == port.cfg
    ours, theirs = port.state_dict(), loaded.state_dict()
    assert set(ours) == set(theirs)
    for k in ours:
        assert torch.allclose(ours[k], theirs[k], rtol=1e-6, atol=1e-7), k


def test_a_bare_wavlm_file_needs_its_layout(tmp_path):
    """The layout is the caller's alone: a WavLM file read as the default
    HuBERT-large is refused (its bias-free convs have no ``conv.bias``),
    never taken for WavLM by its keys."""
    from diffsheg_tpu_torch.compat import hubert_ckpt
    _, port = small_pair()
    torch.save(hf_named(port), tmp_path / "w.bin")
    with pytest.raises(KeyError):
        hubert_ckpt.load_hf_hubert(str(tmp_path / "w.bin"))
    assert (hubert_ckpt.load_hf_hubert(str(tmp_path / "w.bin"), port.cfg).cfg
            == port.cfg)


def test_long_audio_runner_takes_wavlm():
    """``HubertFeatureExtractor`` (the streams' runner) with WavLM against
    the reference's long-audio runner, 3 s of audio resampled to 45
    frames."""
    from diffsheg_tpu_torch.audio.hubert_runner import HubertFeatureExtractor
    ref, port = small_pair()
    audio = torch.randn(1, 48000, generator=torch.Generator().manual_seed(2))
    ext = HubertFeatureExtractor(port.cfg, model=port, device="cpu")
    with torch.no_grad():
        got = ext(audio[0], target_frames=45)
        want = ref_speech.hubert_features(ref, audio, 45)
    assert got.shape == want.shape == (1, 45, 64)
    assert rel_rms(got.numpy(), want.numpy()) <= TOL


def test_presets_and_names():
    w = wavlm_large_config()
    assert (w.hidden_size, w.num_layers, w.num_heads, w.intermediate_size,
            w.rel_pos_buckets, hubert.REL_POS_MAX_DISTANCE,
            w.conv_bias) == (1024, 24, 16, 4096, 320, 800, False)
    assert hubert.speech_encoder_config("wavlm-large") == w
    assert hubert.speech_encoder_config("hubert-large") == HubertConfig()
    with pytest.raises(ValueError, match="valid encoders"):
        hubert.speech_encoder_config("wavlm-base")


@pytest.mark.parametrize("layout", ["hubert-large", "wav2vec2-base"])
def test_hubert_layouts_keep_todays_attention(layout):
    cfg = dataclasses.replace(hubert.speech_encoder_config(layout),
                              num_layers=2, hidden_size=32, num_heads=2,
                              intermediate_size=64, conv_dim=(8,) * 7)
    assert cfg.rel_pos_buckets == 0
    model = HubertModel(cfg).eval()
    assert all(type(getattr(model, f"layer_{i}").attn)
               is hubert.HubertSelfAttention for i in range(2))
    assert not any("rel_" in n or "gru_" in n
                   for n, _ in model.named_parameters())
    before = dict(hubert.attention_calls)
    with torch.no_grad():
        model(torch.randn(1, 16400))
    assert hubert.attention_calls["plain"] - before.get("plain", 0) == 2
    assert hubert.attention_calls["gated_bias"] == before.get("gated_bias", 0)


def tiny_wavlm():
    return HubertConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in dict(SMALL, hidden_size=16,
                                            num_heads=2, intermediate_size=32,
                                            conv_dim=[8] * 7).items()})


def test_cli_train_selects_wavlm_by_settings(tmp_path, monkeypatch):
    from diffsheg_tpu_torch.cli import main as cli
    from diffsheg_tpu_torch.data.cache import CacheWriter
    monkeypatch.setitem(hubert.SPEECH_ENCODERS, "wavlm-large", tiny_wavlm)
    T, S = 34, int(34 / 15 * 16000)
    rs = np.random.RandomState(0)
    w = CacheWriter(str(tmp_path / "cache"), meta={"n_poses": T})
    for i in range(4):
        w.add({"pose": rs.randn(T, 141), "pose_axis_angle": rs.randn(T, 141),
               "mel": rs.randn(T, 128), "facial": rs.randn(T, 51),
               "sem": rs.rand(T), "id": np.asarray([i], np.int32),
               "audio": (rs.randn(S) * 0.1).astype(np.float32)})
    w.finalize()
    before = hubert.attention_calls["gated_bias"]
    assert cli.main([
        "train", "--device", "cpu", "--workdir", str(tmp_path / "run"),
        "--train-cache", str(tmp_path / "cache"), "--epochs", "1",
        "--speech-encoder", "wavlm-large",
        "--set", "train.on_device_frontend=true",
        "--set", "train.batch_size=4", "--set", "train.log_every=1",
        "--set", "model.latent_dim=32", "--set", "model.num_layers=1",
        "--set", "model.num_heads=2", "--set", "model.ff_size=64",
        "--set", "model.hubert_dim=16",
        "--set", "model.hubert_latent_dim=8"]) == 0
    # one step, 4 windows in one chunk, one attention call a layer
    assert hubert.attention_calls["gated_bias"] - before == 2


def test_cli_generate_selects_wavlm_by_settings(tmp_path, monkeypatch):
    import wave
    from diffsheg_tpu_torch.cli.main import main
    monkeypatch.setitem(hubert.SPEECH_ENCODERS, "wavlm-large", tiny_wavlm)
    t = np.arange(48000) / 16000
    pcm = (0.3 * np.sin(2 * np.pi * 220 * t) * 32767).astype("<i2")
    with wave.open(str(tmp_path / "a.wav"), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(pcm.tobytes())
    before = hubert.attention_calls["gated_bias"]
    assert main(["generate", "--device", "cpu", "--audio",
                 str(tmp_path / "a.wav"), "--speakers", "2", "--out-dir",
                 str(tmp_path / "out"), "--speech-encoder", "wavlm-large",
                 "--set", "model.latent_dim=32", "--set", "model.num_layers=1",
                 "--set", "model.num_heads=2", "--set", "model.ff_size=64",
                 "--set", "model.hubert_dim=16",
                 "--set", "model.hubert_latent_dim=8"]) == 0
    assert hubert.attention_calls["gated_bias"] > before


def test_cli_loads_a_checkpoint_in_the_named_layout(tmp_path, monkeypatch):
    from diffsheg_tpu_torch.cli.main import _load_hubert, _speech_encoder
    from diffsheg_tpu_torch.config import beat_config
    monkeypatch.setitem(hubert.SPEECH_ENCODERS, "wavlm-large",
                        lambda: small_pair()[1].cfg)
    _, port = small_pair()
    torch.save(hf_named(port), tmp_path / "w.bin")

    class Args:
        speech_encoder = "wavlm-large"

    loaded = _load_hubert(beat_config(), str(tmp_path / "w.bin"),
                          _speech_encoder(Args))
    assert loaded.cfg == port.cfg
    Args.speech_encoder = None
    assert _speech_encoder(Args) is None
