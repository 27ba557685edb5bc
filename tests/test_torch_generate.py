"""Port parity: custom-audio generation (``cli generate`` and what it runs).

- ``CustomAudioPipeline.generate`` against JAX's on a tiny config (two
  layers, latent 64, a tiny HuBERT), a 3 s synthetic wav (two windows,
  the second left-shifted), two speakers in one batch, the JAX key chain
  replayed into the port's sampler; both ``stream.single_dispatch``
  values (one pipeline call, or the staged mel / HuBERT / sampler path)
  and ``stream.same_overlap_noisy`` (staged, the host window loop).
  Samples of a random model grow large, so the bound is relative, the
  band of ``test_torch_pipeline.py``: rel-RMS <= 1e-4 and max-abs <=
  1e-4 of max |ref|;
- ``main(["generate", ..., "--device", "cpu"])``: its motion equals a
  direct ``CustomAudioPipeline.generate`` with the same seed bit for bit,
  and it writes the files JAX's ``cmd_generate`` writes from the same
  normalized motion (npy and face JSON equal, BVH numbers within 1e-3
  degrees); ``--set stream.single_dispatch=false`` selects the staged
  path; the speaker-range refusal word for word;
- ``export-ckpt`` round-trips a reference ``.tar``; ``view`` writes the
  player JAX's ``view`` writes;
- ``audio/wav.py``: 8/16/24/32-bit PCM, stereo, and the polyphase
  resample, equal to JAX's.
"""

import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (beat_template_text, config_pair,  # noqa: E402
                          jax_denoiser, perturb, rel_rms, stream_noise,
                          torch_denoiser)

HUB = dict(hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32,
           conv_dim=(8,) * 7)
TINY = ["--set", "model.latent_dim=32", "--set", "model.num_layers=1",
        "--set", "model.num_heads=2", "--set", "model.ff_size=64",
        "--set", "model.add_hubert=false"]


def _speech(secs, sr, seed):
    t = np.arange(int(secs * sr)) / sr
    phase = 2 * np.pi * np.cumsum(160 + 60 * np.sin(2 * np.pi * 0.3 * t)) / sr
    env = (0.5 + 0.5 * np.sin(2 * np.pi * 4 * t)) ** 2
    noise = np.random.RandomState(seed).randn(t.size)
    return 0.4 * np.sin(phase) * env + 0.02 * noise


def _write_wav(path, x, sr=16000, width=2, channels=1):
    """PCM ``x`` in [-1, 1] (frames, or frames x channels) at ``width``
    bytes a sample."""
    x = np.asarray(x, np.float64).reshape(-1)
    if width == 1:
        raw = np.clip(x * 127 + 128, 0, 255).astype(np.uint8).tobytes()
    elif width == 3:
        v = np.clip(x * 8388607, -8388608, 8388607).astype(np.int32)
        raw = (v.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3]
               .tobytes())
    else:
        dt, scale = {2: ("<i2", 32767), 4: ("<i4", 2147483647)}[width]
        raw = (x * scale).astype(dt).tobytes()
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(raw)
    return str(path)


# -- the pipeline against JAX's ---------------------------------------------

def _hubert_pair(seed):
    from diffsheg_tpu.audio.hubert_runner import HubertFeatureExtractor as JH
    from diffsheg_tpu.models.hubert import HubertConfig as JC
    from diffsheg_tpu_torch.compat.from_jax import load_flax_tree
    from diffsheg_tpu_torch.models.hubert import HubertConfig, HubertModel
    jh = JH(JC(**HUB), rng=jax.random.PRNGKey(seed))
    variables = perturb(jax.tree.map(np.asarray, dict(jh.variables)),
                        seed + 1)
    return (jax.tree.map(jnp.asarray, variables),
            load_flax_tree(HubertModel(HubertConfig(**HUB)), variables))


@pytest.mark.parametrize("single_dispatch,noisy", [
    (True, False), (False, False), (True, True)],
    ids=["single-dispatch", "staged", "same-overlap-noisy"])
def test_pipeline_generate_matches_jax(single_dispatch, noisy, tmp_path,
                                       monkeypatch):
    import diffsheg_tpu.audio.hubert_runner as jrunner
    from diffsheg_tpu.cli.generate import CustomAudioPipeline as JP
    from diffsheg_tpu.models.hubert import HubertConfig as JC
    from diffsheg_tpu_torch.cli.generate import CustomAudioPipeline as PP
    from diffsheg_tpu_torch.sampling.streamer import window_starts

    jcfg, tcfg = config_pair(
        "beat", model={"hubert_dim": HUB["hidden_size"]},
        diffusion={"jump_n_sample": 2},
        stream={"single_dispatch": single_dispatch,
                "same_overlap_noisy": noisy})
    variables = jax_denoiser(jcfg, seed=41)
    jhub, phub = _hubert_pair(42)
    # the JAX pipeline builds its extractor at HuBERT-large geometry; give
    # it the tiny one the weights are for
    jh_cls = jrunner.HubertFeatureExtractor
    monkeypatch.setattr(jrunner, "HubertFeatureExtractor",
                        lambda variables=None: jh_cls(JC(**HUB),
                                                      variables=variables))
    wav = _write_wav(tmp_path / "clip.wav", _speech(3.0, 16000, 43))
    speakers, seed = [2, 5], 44

    jpipe = JP(jcfg, jax.tree.map(jnp.asarray, variables),
               hubert_variables=jhub)
    ref = jpipe.generate(wav, speakers, seed=seed)
    gen = jpipe.generator
    T = ref.motion.shape[1]
    starts = window_starts(T, 34, 30)
    assert T == 45 and starts == [0, 11]
    noise = stream_noise(jax.random.PRNGKey(seed), len(starts), 2, 34,
                         jcfg.model.motion_dim, gen._plain, gen._harmonize)
    ppipe = PP(tcfg, torch_denoiser(tcfg, variables), hubert_model=phub,
               device="cpu")
    got = ppipe.generate(wav, speakers, noise=noise)
    assert got.motion.shape == ref.motion.shape == (2, 45, 192)
    assert got.motion.dtype == np.float32 and np.isfinite(got.motion).all()
    err = (rel_rms(got.motion, ref.motion),
           np.abs(got.motion - ref.motion).max() / np.abs(ref.motion).max())
    assert err[0] <= 1e-4 and err[1] <= 1e-4, err
    # saved noisy tails run the staged path's host window loop
    stages = {"pipeline", "total"} if single_dispatch and not noisy else {
        "mel", "hubert", "sampler", "total"}
    assert set(got.stages) == set(ref.stages) == stages
    assert got.fps > 0 and got.rtf == pytest.approx(got.fps / 15)


# -- the command line -------------------------------------------------------

def _beat_stats(path, seed=0):
    from diffsheg_tpu_torch.data.beat import BeatStats
    rng = np.random.RandomState(seed)
    BeatStats(rng.randn(141), 0.5 + rng.rand(141), 0.3 * rng.randn(141),
              0.5 + rng.rand(141), rng.rand(51),
              0.5 + rng.rand(51)).save(str(path))
    return str(path)


def _jax_cmd(argv):
    """Run a JAX CLI subcommand in-process (its parser and handler, not
    ``main``, which would also point JAX at a compile cache)."""
    from diffsheg_tpu.cli.main import build_parser
    args = build_parser().parse_args(argv)
    return args.fn(args)


def _files(d):
    return sorted(os.listdir(d))


def _fixed_motion(monkeypatch, module, motion):
    """``module``'s CustomAudioPipeline.generate returns ``motion``."""
    monkeypatch.setattr(module.CustomAudioPipeline, "generate",
                        lambda self, *a, **kw: module.GenerationResult(
                            motion=motion, fps=1.0, rtf=1.0, stages={}))


def _same_files(port, ref, bvh_tol):
    """The same file names; npy and JSON equal; BVH frames of the same
    shape, finite, within ``bvh_tol`` degrees (unless None)."""
    from diffsheg_tpu_torch.geometry.bvh import parse_bvh_file
    names = _files(port)
    assert names == _files(ref) == sorted(
        f"talk_{b}{ext}" for b in (0, 1) for ext in (
            ".npy", ".bvh", "_face.json", "_player.html"))
    for name in names:
        p, j = port / name, ref / name
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(p), np.load(j))
        elif name.endswith(".json"):
            assert p.read_text() == j.read_text()
        elif name.endswith(".bvh"):
            a, b = parse_bvh_file(str(p)).frames, parse_bvh_file(str(j)).frames
            assert a.shape == b.shape == (45, 228)
            assert np.isfinite(a).all()
            if bvh_tol is not None:
                assert np.abs(a - b).max() <= bvh_tol


def test_cli_generate_equals_pipeline_and_writes_jax_files(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    import diffsheg_tpu.cli.generate as J
    import diffsheg_tpu_torch.cli.generate as P
    from diffsheg_tpu_torch.cli.main import _base_config, main
    from diffsheg_tpu_torch.models.factory import init_denoiser

    wav = _write_wav(tmp_path / "talk.wav", _speech(3.0, 16000, 5), width=3)
    stats = _beat_stats(tmp_path / "stats")
    tmpl = tmp_path / "tmpl.bvh"
    tmpl.write_text(beat_template_text(frames=1, seed=6))
    results = []
    generate = P.CustomAudioPipeline.generate

    def spy(self, *a, **kw):
        results.append(generate(self, *a, **kw))
        return results[-1]

    monkeypatch.setattr(P.CustomAudioPipeline, "generate", spy)
    flags = ["--audio", wav, "--stats-dir", stats, "--speakers", "1,3",
             "--template-bvh", str(tmpl), "--player", "--seed", "4"] + TINY
    assert main(["generate", "--device", "cpu",
                 "--out-dir", str(tmp_path / "port")] + flags) == 0
    out = capsys.readouterr().out
    assert "generated (2, 45, 192)" in out and "pipeline=" in out
    motion = results[0].motion

    # the CLI adds nothing to the motion: a direct pipeline call with the
    # same model (the CLI's random init, seed 0) and seed gives the same
    class Args:
        dataset, set = "beat", TINY[1::2]
    cfg = _base_config(Args)
    direct = generate(P.CustomAudioPipeline(
        cfg, init_denoiser(cfg.model, seed=0), device="cpu"),
        wav, [1, 3], seed=4)
    np.testing.assert_array_equal(direct.motion, motion)

    # the staged path, selected from the command line
    assert main(["generate", "--device", "cpu", "--audio", wav,
                 "--speakers", "2", "--out-dir", str(tmp_path / "staged"),
                 "--set", "stream.single_dispatch=false"] + TINY) == 0
    out = capsys.readouterr().out
    assert "mel=" in out and "sampler=" in out and "pipeline=" not in out
    assert _files(tmp_path / "staged") == ["talk_0.npy"]
    assert results[-1].motion.shape == (1, 45, 192)

    # JAX's command writes the same files from the same normalized motion:
    # npy and face JSON bit for bit, the BVH of the same shape
    _fixed_motion(monkeypatch, J, motion)
    assert _jax_cmd(["generate", "--out-dir", str(tmp_path / "jax")]
                    + flags) == 0
    _same_files(tmp_path / "port", tmp_path / "jax", bvh_tol=None)
    # a random model's samples reach ~1e5, and the euler angles of a 1e5
    # rad axis-angle are f32 argument-reduction noise in either package:
    # the BVH numbers are held on normalized motion of unit scale, the
    # same through both commands
    unit = np.random.RandomState(12).randn(*motion.shape).astype(np.float32)
    _fixed_motion(monkeypatch, P, unit)
    _fixed_motion(monkeypatch, J, unit)
    assert main(["generate", "--device", "cpu",
                 "--out-dir", str(tmp_path / "port1")] + flags) == 0
    assert _jax_cmd(["generate", "--out-dir", str(tmp_path / "jax1")]
                    + flags) == 0
    _same_files(tmp_path / "port1", tmp_path / "jax1", bvh_tol=1e-3)


def test_cli_refusals_word_for_word(tmp_path, monkeypatch):
    from diffsheg_tpu_torch.cli.main import main
    wav = _write_wav(tmp_path / "a.wav", _speech(1.0, 16000, 7))
    flags = ["--audio", wav, "--speakers", "1,30,-1"] + TINY
    with pytest.raises(SystemExit) as ours:
        main(["generate", "--device", "cpu"] + flags)
    with pytest.raises(SystemExit) as ref:
        _jax_cmd(["generate"] + flags)
    assert str(ours.value) == str(ref.value)
    assert "[30, -1] out of range for style_dim=30" in str(ours.value)
    # an Orbax directory is the JAX package's format, as for serve
    with pytest.raises(SystemExit, match="is the JAX package's format"):
        main(["generate", "--device", "cpu", "--checkpoint", str(tmp_path),
              "--audio", wav, "--speakers", "1"] + TINY)
    bvh = tmp_path / "x.bvh"
    bvh.write_text(beat_template_text(frames=2))
    with pytest.raises(SystemExit) as ours:
        main(["view", "--bvh", str(bvh), "--stride", "0"])
    with pytest.raises(SystemExit) as ref:
        _jax_cmd(["view", "--bvh", str(bvh), "--stride", "0"])
    assert str(ours.value) == str(ref.value)


def test_export_ckpt_round_trips_a_tar(tmp_path, capsys):
    from diffsheg_tpu_torch.cli.main import _base_config, main
    from diffsheg_tpu_torch.compat.torch_ckpt import save_reference_checkpoint
    from diffsheg_tpu_torch.models.factory import init_denoiser

    class Args:
        dataset, set = "beat", TINY[1::2]
    model = init_denoiser(_base_config(Args).model, seed=3)
    src = save_reference_checkpoint(model, str(tmp_path / "a.tar"), epoch=2)
    assert main(["export-ckpt", "--checkpoint", src, "--out",
                 str(tmp_path / "b.tar"), "--epoch", "7"] + TINY) == 0
    assert "exported:" in capsys.readouterr().out
    a = torch.load(src, weights_only=True)
    b = torch.load(str(tmp_path / "b.tar"), weights_only=True)
    assert (a["ep"], b["ep"]) == (2, 7)
    assert a["encoder"].keys() == b["encoder"].keys()
    for k, v in a["encoder"].items():
        assert torch.equal(v, b["encoder"][k]), k
    with pytest.raises(SystemExit, match="is the JAX package's format"):
        main(["export-ckpt", "--checkpoint", str(tmp_path), "--out",
              str(tmp_path / "c.tar")] + TINY)


def test_view_writes_the_jax_player(tmp_path, capsys):
    from diffsheg_tpu_torch.cli.main import main
    from diffsheg_tpu_torch.geometry.face import write_face_json
    bvh = tmp_path / "clip.bvh"
    bvh.write_text(beat_template_text(frames=9, seed=8))
    face = str(tmp_path / "clip_face.json")
    write_face_json(np.random.RandomState(9).rand(9, 51), face)
    assert main(["view", "--bvh", str(bvh), "--face", face,
                 "--stride", "2"]) == 0
    assert "player:" in capsys.readouterr().out
    ours = tmp_path / "clip_player.html"
    _jax_cmd(["view", "--bvh", str(bvh), "--face", face, "--stride", "2",
              "--out", str(tmp_path / "jax.html")])
    assert ours.read_text() == (tmp_path / "jax.html").read_text()


# -- wav IO ------------------------------------------------------------------

@pytest.mark.parametrize("width,channels", [(1, 1), (2, 1), (3, 1), (4, 1),
                                            (2, 2), (3, 2)])
def test_load_wav_matches_jax(width, channels, tmp_path):
    from diffsheg_tpu.audio.wav import load_wav as jload
    from diffsheg_tpu_torch.audio.wav import load_wav
    x = np.clip(_speech(0.25, 16000, width) * 2, -1, 1)
    x = np.repeat(x, channels) if channels > 1 else x
    path = _write_wav(tmp_path / "w.wav", x, width=width, channels=channels)
    got, sr = load_wav(path)
    want, jsr = jload(path)
    assert sr == jsr == 16000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.shape == (4000,)
    # PCM quantization, plus f32 rounding at 32 bits
    assert np.abs(got - x[::channels]).max() <= 2.0 / 2 ** (8 * width - 1) + 1e-7


@pytest.mark.parametrize("orig,target", [(16000, 18000), (44100, 16000),
                                         (48000, 18000), (16000, 16000)])
def test_resample_poly_matches_jax(orig, target):
    from diffsheg_tpu.audio.wav import resample_poly as jres
    from diffsheg_tpu_torch.audio.wav import resample_poly
    x = _speech(0.2, orig, 10).astype(np.float32)
    np.testing.assert_array_equal(resample_poly(x, orig, target),
                                  jres(x, orig, target))
