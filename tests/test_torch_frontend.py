"""The speech frontend inside the training step (``diffsheg_tpu_torch/audio/
{resample,frontend}.py``) against the JAX package's, on the CPU.

  - ``resample_poly_device`` against scipy and JAX's at 1e-5 of scale (JAX's
    own bound) on the four shapes of ``tests/test_frontend.py``, and the
    identity;
  - the mel branch against JAX's ``make_speech_frontend`` and the port's
    cache builder (host scipy resample + mel), 2e-5 of scale;
  - the HuBERT branch on JAX's weights, in both layouts (unrolled and the
    stacked ``scan_layers`` one), f32 rel-RMS <= 1e-5, and window by
    window against one chunk (rel-RMS <= 1e-6: the CPU's kernels round
    differently at another batch size);
  - the int16 transport;
  - 3 injected steps of the port's step on the frontend's batch, as the
    trainer runs them, against JAX's ``make_train_step(..., frontend=...)``
    at ``test_torch_train_step.py``'s tolerance;
  - ``Trainer`` with ``train.on_device_frontend``: fit, then the trained
    weights evaluated by both packages' trainers on the same noise;
  - ``cli train --hubert-checkpoint`` with a HF state dict written here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import config_pair, mel_close, rel_rms

from diffsheg_tpu.audio import frontend as jfrontend
from diffsheg_tpu.audio.resample import resample_poly_device as jresample
from diffsheg_tpu_torch.audio import frontend as frontend_mod
from diffsheg_tpu_torch.audio.frontend import make_speech_frontend
from diffsheg_tpu_torch.audio.resample import (output_len,
                                               resample_poly_device)
from diffsheg_tpu_torch.compat.from_jax import export_flax_tree, load_flax_tree
from diffsheg_tpu_torch.models.hubert import HubertConfig, HubertModel

T = 34
S = int(T / 15 * 16000)          # one BEAT window of 16 kHz audio


def tiny_hubert(jax_side: bool, layers: int = 2):
    """The full conv stack's geometry (stride 320, kernel 400) with a tiny
    encoder."""
    if jax_side:
        from diffsheg_tpu.models.hubert import HubertConfig as JHubertConfig
        cls = JHubertConfig
    else:
        cls = HubertConfig
    return cls(hidden_size=16, num_layers=layers, num_heads=2,
               intermediate_size=32, conv_dim=(8,) * 7)


def pair(add_hubert=False, **train):
    return config_pair(
        model=dict(num_layers=1, add_hubert=add_hubert, hubert_dim=16,
                   hubert_latent_dim=8),
        data=dict(n_poses=T), train=dict(on_device_frontend=True, **train))


def jax_hubert_variables(layers: int = 2, seed: int = 0):
    """Seeded JAX HuBERT weights (unrolled), every leaf perturbed."""
    from diffsheg_tpu.models.hubert import HubertModel as JHubertModel
    from torch_parity import perturb
    v = JHubertModel(tiny_hubert(True, layers)).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 1600)))
    return {"params": perturb(jax.tree.map(np.asarray, v["params"]),
                              seed + 1, scale=0.05)}


def waves(B, seed):
    return (np.random.RandomState(seed).randn(B, S) * 0.1).astype(np.float32)


@pytest.mark.parametrize("n,up,down", [
    (36266, 9, 8),      # the BEAT window: 16 kHz -> 18 kHz
    (1000, 9, 8),
    (777, 2, 3),        # downsampling
    (5000, 160, 441),   # a 16 kHz -> 44.1 kHz-style ratio
    (64, 4, 4),         # up == down: the input itself
])
def test_resample_matches_scipy_and_jax(n, up, down):
    from scipy.signal import resample_poly
    x = np.random.RandomState(0).randn(2, n).astype(np.float32)
    got = resample_poly_device(torch.from_numpy(x), up, down)
    if up == down:
        assert got.data_ptr() == torch.from_numpy(x).data_ptr() or \
            np.array_equal(got.numpy(), x)
        np.testing.assert_array_equal(np.asarray(jresample(
            jnp.asarray(x), up, down)), got.numpy())
        return
    ref = np.stack([resample_poly(r.astype(np.float64), up, down) for r in x])
    jx = np.asarray(jresample(jnp.asarray(x), up, down))
    assert got.shape == ref.shape == jx.shape == (2, output_len(n, up, down))
    scale = np.abs(ref).max()
    assert np.abs(got.numpy() - ref).max() / scale < 1e-5
    assert np.abs(got.numpy() - jx).max() / scale < 1e-5


def test_mel_branch_matches_jax_and_the_cache_builder():
    from diffsheg_tpu_torch.data.beat import BeatBuildConfig, _mel_windows
    jcfg, tcfg = pair()
    wave = waves(3, 0)
    motion = np.zeros((3, T, 4), np.float32)
    want = np.asarray(jfrontend.make_speech_frontend(jcfg)(
        {"wave16": jnp.asarray(wave), "motion": jnp.asarray(motion)})["mel"])
    got = make_speech_frontend(tcfg, device="cpu")(
        {"wave16": torch.from_numpy(wave), "motion": torch.from_numpy(motion)})
    assert "wave16" not in got and "hubert" not in got
    assert got["mel"].shape == want.shape == (3, T, tcfg.data.n_mels)
    mel_close(got["mel"].numpy(), want)
    mel_close(got["mel"].numpy(), _mel_windows(wave, BeatBuildConfig(), T,
                                               device="cpu"))


@pytest.mark.parametrize("layout", ["unrolled", "scan_layers"])
def test_hubert_branch_matches_jax(layout, monkeypatch):
    """JAX's weights in either layout load into the port's encoder; the
    features match JAX's frontend, and chunking the windows changes only
    the rounding."""
    from diffsheg_tpu.models.hubert import stack_layer_params
    jcfg, tcfg = pair(add_hubert=True)
    variables = jax_hubert_variables()
    wave = waves(3, 1)
    motion = np.zeros((3, T, 4), np.float32)
    want = np.asarray(jfrontend.make_speech_frontend(
        jcfg, hubert_variables=variables, hubert_cfg=tiny_hubert(True))(
        {"wave16": jnp.asarray(wave), "motion": jnp.asarray(motion)})[
        "hubert"])
    tree = (stack_layer_params(jax.tree.map(jnp.asarray, variables), 2)
            if layout == "scan_layers" else variables)
    model = load_flax_tree(HubertModel(tiny_hubert(False)),
                           jax.tree.map(np.asarray, tree))
    batch = {"wave16": torch.from_numpy(wave),
             "motion": torch.from_numpy(motion)}
    got = make_speech_frontend(tcfg, model, device="cpu")(batch)["hubert"]
    assert got.shape == want.shape == (3, T, 16) and got.dtype == torch.float32
    assert rel_rms(got.numpy(), want) <= 1e-5
    # window by window: the same numbers up to the last bits, which the
    # CPU's convolution and matrix-product kernels round differently at
    # another batch size (their algorithm follows it); a row mixed up or
    # padded wrong would be off by O(1)
    monkeypatch.setattr(frontend_mod, "HUBERT_CHUNK", 1)
    one = make_speech_frontend(tcfg, model, device="cpu")(batch)
    assert rel_rms(one["hubert"].numpy(), got.numpy()) <= 1e-6


def test_int16_transport_dequantizes():
    _, tcfg = pair()
    wave = waves(2, 2)
    q = np.clip(wave * 32768.0, -32768, 32767).astype(np.int16)
    fe = make_speech_frontend(tcfg, device="cpu")
    motion = torch.zeros(2, T, 4)
    a = fe({"wave16": torch.from_numpy(wave), "motion": motion})["mel"]
    b = fe({"wave16": torch.from_numpy(q), "motion": motion})["mel"]
    c = fe({"wave16": torch.from_numpy(q.astype(np.float32) / 32768.0),
            "motion": motion})["mel"]
    assert torch.equal(b, c)
    assert (a - b).abs().max() / a.abs().max() < 1e-3


def test_three_injected_steps_with_the_frontend_match_jax():
    """Raw int16 audio in the batch, mel and HuBERT computed from it: the
    port's frontend then its step, as its trainer runs them, against JAX's
    fused variant, 3 steps on JAX's weights and draws
    (test_torch_train_step.py's comparison, 1e-5)."""
    from test_torch_train_step import (compare_states, draws, jax_state,
                                       seeded_variables, torch_state)
    from diffsheg_tpu.diffusion.schedule import get_named_beta_schedule as jb
    from diffsheg_tpu.diffusion.schedule import make_schedule as jm
    from diffsheg_tpu.train import step as jstep
    from diffsheg_tpu_torch.diffusion.schedule import (
        get_named_beta_schedule, make_schedule)
    from diffsheg_tpu_torch.train import step as tstep
    jcfg, tcfg = pair(add_hubert=True)
    B = 2
    rs = np.random.RandomState(3)
    wave = np.clip(waves(B, 3) * 32768.0, -32768, 32767).astype(np.int16)
    batch = {"motion": rs.randn(B, T, 192).astype(np.float32) * 0.5,
             "wave16": wave,
             "pid": np.eye(30, dtype=np.float32)[[3, 7]],
             "sem": rs.rand(B, T).astype(np.float32)}
    rolls = [(t[:B], n[:B]) for t, n in draws(192, 9)]
    rolls = [(t, np.resize(n, (B, T, 192))) for t, n in rolls]
    hub = jax_hubert_variables(seed=4)
    tree = seeded_variables(tcfg, 7)

    jfe = jfrontend.make_speech_frontend(jcfg, hubert_variables=hub,
                                         hubert_cfg=tiny_hubert(True))
    jsched = jm(jb("linear", 1000))
    jst = jstep.make_train_step(jcfg, jsched, inject_randoms=True,
                                frontend=jfe)
    js = jax_state(jcfg, tree)
    jb_ = {k: jnp.asarray(v) for k, v in batch.items()}
    jterms = []
    for t, n in rolls:
        js, tm = jst(js, jb_, jnp.asarray(t), jnp.asarray(n))
        jterms.append({k: float(v) for k, v in tm._asdict().items()})
    js = jax.tree.map(np.asarray, js)

    model = load_flax_tree(HubertModel(tiny_hubert(False)), hub)
    tfe = make_speech_frontend(tcfg, model, device="cpu")
    tst = tstep.make_train_step(
        tcfg, make_schedule(get_named_beta_schedule("linear", 1000)),
        inject_randoms=True)
    ts = torch_state(tcfg, tree)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tterms = []
    for t, n in rolls:
        ts, tm = tst(ts, tfe(tb), torch.from_numpy(t).long(),
                     torch.from_numpy(n))
        tterms.append({k: float(v) for k, v in tm._asdict().items()})
    assert "wave16" in tb      # the caller's batch is left as it was
    compare_states(jcfg, js, ts, jterms, tterms, 1e-5)


class AudioWindows:
    """Synthetic windows with raw audio: the BeatDataset batch contract
    with ``include_audio``."""

    def __init__(self, cfg, n, seed):
        rng = np.random.RandomState(seed)
        m = cfg.model
        self.data = {
            "motion": rng.randn(n, T, m.motion_dim).astype(np.float32) * .5,
            "audio": (rng.randn(n, S) * 0.1).astype(np.float32),
            "sem": rng.rand(n, T).astype(np.float32),
            "id": rng.randint(0, m.style_dim, (n, 1)).astype(np.int32)}
        self.n = n

    def __len__(self):
        return self.n

    def batch(self, idx):
        return {k: v[idx] for k, v in self.data.items()}


def test_trainer_fit_and_evaluate_with_the_frontend_match_jax(tmp_path):
    """The port's trainer fits an epoch on raw audio (its loss terms
    logged); then its trained weights go into JAX's trainer and both
    evaluate the same val windows (the frontend before the generator) on
    JAX's noise: MSE, PCK, PCK@2, diversity."""
    from diffsheg_tpu.data.loader import ShardedBatchLoader as JLoader
    from diffsheg_tpu.train.trainer import Trainer as JTrainer
    from diffsheg_tpu_torch.data.loader import ShardedBatchLoader
    from diffsheg_tpu_torch.diffusion.sampler import TableNoise
    from diffsheg_tpu_torch.train.trainer import Trainer
    from torch_parity import jax_window_noise
    B = 8                   # JAX's trainer splits it over 8 devices
    jcfg, tcfg = pair(batch_size=B, num_epochs=1, log_every=1,
                      eval_every_epochs=0, save_every_epochs=0)
    jcfg = jcfg.replace(diffusion=dataclasses.replace(jcfg.diffusion,
                                                      respacing="ddim5"))
    tcfg = tcfg.replace(diffusion=dataclasses.replace(tcfg.diffusion,
                                                      respacing="ddim5"))
    train, val = AudioWindows(tcfg, 2 * B, 0), AudioWindows(tcfg, B, 1)

    ours = Trainer(tcfg, str(tmp_path / "ours"), device="cpu")
    ours.fit(ShardedBatchLoader(train, global_batch_size=B, prefetch=0))
    recs = (tmp_path / "ours" / "metrics.jsonl").read_text()
    assert recs.count('"total"') == 2
    theirs = JTrainer(jcfg, str(tmp_path / "theirs"))
    trained = export_flax_tree(ours.state.model)
    theirs.state = theirs.state._replace(
        params=jax.tree.map(jnp.asarray, trained["params"]),
        batch_stats=jax.tree.map(jnp.asarray, trained["batch_stats"]))
    key = jax.random.PRNGKey(11)
    want = theirs.evaluate(JLoader(val, global_batch_size=B, prefetch=0),
                           key)
    _, k = jax.random.split(key)
    program = theirs._get_generator()._plain
    init, steps = jax_window_noise(k, B, T, 192, program, False)
    table = TableNoise({0: init},
                       {(0, s, kd): v for (s, kd), v in steps.items()})
    got = ours.evaluate(ShardedBatchLoader(val, global_batch_size=B,
                                           prefetch=0),
                        noise=lambda bi: table)
    for name in ("mse", "pck", "pck2", "diversity"):
        a, b = getattr(got, name), getattr(want, name)
        assert np.isfinite(a) and abs(a - b) <= 1e-4 * max(abs(b), 1e-3), (
            name, a, b)


def test_cli_train_with_the_frontend_and_a_hubert_checkpoint(
        tmp_path, capsys, monkeypatch):
    """``cli train --set train.on_device_frontend=true --hubert-checkpoint
    <HF state dict>`` on a cache with raw audio: the frontend's encoder
    holds the checkpoint's weights, and an epoch trains.  The checkpoint
    is a tiny encoder of HuBERT-large's layout (the loader's default
    configuration narrowed to it here)."""
    import json
    from diffsheg_tpu_torch.cli import main as cli
    from diffsheg_tpu_torch.compat import hubert_ckpt
    from diffsheg_tpu_torch.data.cache import CacheWriter
    from diffsheg_tpu_torch.models.factory import random_init_
    hcfg = tiny_hubert(False, layers=1)
    sd = hubert_ckpt.hf_state_dict(random_init_(HubertModel(hcfg), 3))
    torch.save(sd, str(tmp_path / "pytorch_model.bin"))
    rs = np.random.RandomState(0)
    w = CacheWriter(str(tmp_path / "cache"), meta={"n_poses": T})
    for i in range(4):
        w.add({"pose": rs.randn(T, 141), "pose_axis_angle": rs.randn(T, 141),
               "mel": rs.randn(T, 128), "facial": rs.randn(T, 51),
               "sem": rs.rand(T), "id": np.asarray([i], np.int32),
               "audio": (rs.randn(S) * 0.1).astype(np.float32)})
    w.finalize()
    seen = []
    real = cli._load_hubert

    def load(cfg, path, *layout):
        seen.append((path, real(cfg, path, *layout)))
        return seen[-1][1]
    monkeypatch.setattr(cli, "_load_hubert", load)
    monkeypatch.setattr(hubert_ckpt, "HubertConfig", lambda: hcfg)
    assert cli.main([
        "train", "--device", "cpu", "--workdir", str(tmp_path / "run"),
        "--train-cache", str(tmp_path / "cache"),
        "--hubert-checkpoint", str(tmp_path), "--epochs", "1",
        "--set", "train.on_device_frontend=true",
        "--set", "train.batch_size=4", "--set", "train.log_every=1",
        "--set", "model.latent_dim=32", "--set", "model.num_layers=1",
        "--set", "model.num_heads=2", "--set", "model.ff_size=64",
        "--set", "model.hubert_dim=16",
        "--set", "model.hubert_latent_dim=8"]) == 0
    (path, model), = seen
    assert path == str(tmp_path)
    loaded = model.state_dict()
    assert torch.equal(loaded["layer_0.attn.q_proj.weight"],
                       sd["encoder.layers.0.attention.q_proj.weight"])
    recs = [json.loads(x) for x in open(tmp_path / "run" / "metrics.jsonl")]
    assert sum("total" in r and np.isfinite(r["total"]) for r in recs) == 1
    assert "RANDOM-INIT" not in capsys.readouterr().err
