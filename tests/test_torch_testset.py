"""Test-set streaming and FGD in the evaluation
(``diffsheg_tpu_torch/sampling/testset.py``, ``Trainer.evaluate`` with an
FGD net) against the JAX package's, with JAX's noise replayed: each
clip's output within the f32 rel-RMS 5e-3 band, the metrics within
1e-4; ``output_gt`` and the exporter's files bit for bit."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsheg_tpu.data.beat import BeatDataset as JDataset
from diffsheg_tpu.data.beat import BeatStats as JStats
from diffsheg_tpu.data.loader import ShardedBatchLoader as JLoader
from diffsheg_tpu.eval.fgd_net import FgdNetConfig as JFgdConfig
from diffsheg_tpu.eval.fgd_net import init_fgd_net as jinit_fgd
from diffsheg_tpu.sampling.generator import WindowGenerator as JGen
from diffsheg_tpu.sampling.testset import generate_testset as jtestset
from diffsheg_tpu_torch.compat.from_jax import load_flax_tree
from diffsheg_tpu_torch.data.beat import BeatDataset as TDataset
from diffsheg_tpu_torch.data.beat import BeatStats as TStats
from diffsheg_tpu_torch.data.cache import CacheWriter
from diffsheg_tpu_torch.data.loader import ShardedBatchLoader as TLoader
from diffsheg_tpu_torch.diffusion.sampler import TableNoise
from diffsheg_tpu_torch.eval.fgd_net import FgdFeatureNet, FgdNetConfig
from diffsheg_tpu_torch.sampling.streamer import window_starts
from diffsheg_tpu_torch.sampling.testset import generate_testset
from torch_parity import (config_pair, jax_denoiser, jax_window_noise,
                          perturb, rel_rms, stream_noise, torch_denoiser)

LENGTHS = (50, 64)          # two and two windows of 34 frames, overlap 4


def beat_rows(lengths, seed, whole=True):
    rs = np.random.RandomState(seed)
    rows = []
    for i, T in enumerate(lengths):
        rows.append({
            "pose": rs.randn(T, 141).astype(np.float32),
            "pose_axis_angle": (rs.randn(T, 141) * 0.3).astype(np.float32),
            "audio": (rs.randn(int(T / 15 * 16000)) * 0.05).astype(
                np.float32),
            "mel": rs.randn(T, 128).astype(np.float32),
            "facial": (rs.randn(T, 51) * 0.3).astype(np.float32),
            "sem": rs.rand(T).astype(np.float32),
            "id": np.asarray([3 + i], np.int32)})
    return rows


def write_cache(path, rows, is_test):
    w = CacheWriter(str(path), meta={"n_poses": 34, "is_test": is_test})
    for r in rows:
        w.add(r)
    w.finalize()
    return str(path)


def fgd_pair(seed=3):
    """The same 300-wide FGD net in both packages (JAX's test stream and
    trainer build it at the default width)."""
    _, v = jinit_fgd(JFgdConfig(), jax.random.PRNGKey(seed))
    v = {k: perturb(x, seed) for k, x in jax.tree.map(np.asarray,
                                                       dict(v)).items()}
    net = load_flax_tree(FgdFeatureNet(FgdNetConfig()), v).eval()
    return jax.tree.map(jnp.asarray, v), net


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = config_pair("beat", diffusion=dict(jump_n_sample=2))
    variables = jax_denoiser(jcfg, seed=11)
    return jcfg, tcfg, variables, torch_denoiser(tcfg, variables)


def assert_metrics_close(got, want, keys, tol=1e-4):
    for k in keys:
        assert np.isfinite(got[k]) and abs(got[k] - want[k]) <= tol * max(
            1.0, abs(want[k])), (k, got[k], want[k])


def test_generate_testset_matches_jax(models, tmp_path):
    jcfg, tcfg, variables, model = models
    cache = write_cache(tmp_path / "test", beat_rows(LENGTHS, 12), True)
    jfgd, tfgd = fgd_pair()
    rng = jax.random.PRNGKey(13)
    want = jtestset(jcfg, jax.tree.map(jnp.asarray, variables),
                    JDataset(cache), str(tmp_path / "j"), rng,
                    fgd_variables=jfgd, log=lambda *a: None)
    jgen = JGen(jcfg, jax.tree.map(jnp.asarray, variables))
    C = jcfg.model.motion_dim

    def noise(i):
        return stream_noise(jax.random.fold_in(rng, i),
                            len(window_starts(LENGTHS[i], 34, 30)), 1, 34, C,
                            jgen._plain, jgen._harmonize)
    lines = []
    got = generate_testset(tcfg, model, TDataset(cache), str(tmp_path / "p"),
                           noise=noise, fgd_net=tfgd, log=lines.append,
                           device="cpu")
    for i in range(2):
        a = np.load(tmp_path / "p" / f"clip_{i:05d}.npy")
        b = np.load(tmp_path / "j" / f"clip_{i:05d}.npy")
        assert a.shape == b.shape == (LENGTHS[i], C)
        assert rel_rms(a, b) <= 5e-3
    assert sorted(got) == sorted(want)
    assert got["clips"] == want["clips"] == 2.0 and got["srgr_norm"] == "self"
    assert_metrics_close(got, want, ("mse", "pck", "beat_align", "srgr",
                                     "fgd"))
    assert got["fps"] > 0 and len(lines) == 2
    # max_clips; the same clip's noise gives the same output
    generate_testset(tcfg, model, TDataset(cache), str(tmp_path / "one"),
                     noise=noise, max_clips=1, log=lambda *a: None,
                     device="cpu")
    assert sorted(os.listdir(tmp_path / "one")) == ["clip_00000.npy"]
    np.testing.assert_array_equal(np.load(tmp_path / "one" / "clip_00000.npy"),
                                  np.load(tmp_path / "p" / "clip_00000.npy"))


def test_output_gt_and_exporter_match_jax(models, tmp_path):
    from diffsheg_tpu.sampling.export import BeatMotionExporter as JExp
    from diffsheg_tpu_torch.sampling.export import BeatMotionExporter as TExp
    from torch_parity import beat_template_text
    jcfg, tcfg, variables, model = models
    cache = write_cache(tmp_path / "test", beat_rows(LENGTHS, 14), True)
    rs = np.random.RandomState(15)
    stats = dict(mean_pose=rs.randn(141), std_pose=1 + rs.rand(141),
                 mean_axis_angle=rs.randn(141) * 0.1,
                 std_axis_angle=0.5 + rs.rand(141) * 0.1,
                 mean_facial=rs.rand(51), std_facial=0.5 + rs.rand(51))
    tmpl = tmp_path / "tmpl.bvh"
    tmpl.write_text(beat_template_text(frames=1, seed=16))
    outs = {}
    for tag, fn, Exp, St, dev in (
            ("j", jtestset, JExp, JStats, {}),
            ("p", generate_testset, TExp, TStats, {"device": "cpu"})):
        st = St(**stats)
        exp = Exp(141, 15.0, st.motion_mean, st.motion_std,
                  template_bvh=str(tmpl), **dev)
        args = ((jcfg, jax.tree.map(jnp.asarray, variables), JDataset(cache),
                 str(tmp_path / tag), jax.random.PRNGKey(0))
                if tag == "j" else
                (tcfg, model, TDataset(cache), str(tmp_path / tag)))
        outs[tag] = fn(*args, output_gt=True, exporter=exp,
                       log=lambda *a: None, **dev)
    got, want = outs["p"], outs["j"]
    assert got["mse"] == want["mse"] == 0.0 and got["pck"] == 1.0
    assert np.isnan(got["srgr"]) and np.isnan(want["srgr"])
    assert_metrics_close(got, want, ("beat_align",))
    files = sorted(os.listdir(tmp_path / "p_GT"))
    assert files == sorted(os.listdir(tmp_path / "j_GT")) == [
        f"clip_0000{i}{ext}" for i in range(2)
        for ext in (".bvh", ".npy", "_face.json")]
    for f in files:
        a, b = tmp_path / "p_GT" / f, tmp_path / "j_GT" / f
        if f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        elif f.endswith(".json"):
            assert json.loads(a.read_text()) == json.loads(b.read_text())
        else:
            from diffsheg_tpu_torch.geometry.bvh import parse_bvh_file
            np.testing.assert_allclose(parse_bvh_file(str(a)).frames,
                                       parse_bvh_file(str(b)).frames,
                                       atol=1e-3)


def test_trainer_evaluate_fgd_matches_jax(models, tmp_path):
    from diffsheg_tpu.train.trainer import Trainer as JTrainer
    from diffsheg_tpu_torch.train.trainer import Trainer as TTrainer
    jcfg, tcfg, variables, _ = models
    cache = write_cache(tmp_path / "val", beat_rows((34,) * 8, 17), False)
    jfgd, tfgd = fgd_pair(seed=4)
    jt = JTrainer(jcfg, str(tmp_path / "jw"), fgd_variables=jfgd)
    jt.state = jt.state._replace(
        params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
    rng = jax.random.PRNGKey(18)
    # no prefetch thread: the JAX loader drops its end mark when its queue
    # is full and its consumer then waits forever (ROADMAP, Queue 3)
    want = jt.evaluate(JLoader(JDataset(cache), 4, shuffle=False,
                               prefetch=0), rng)
    tt = TTrainer(tcfg, str(tmp_path / "tw"), device="cpu", fgd_net=tfgd)
    load_flax_tree(tt.state.model, variables)
    jgen = jt._get_generator()
    keys = []
    for _ in range(2):
        rng, k = jax.random.split(rng)
        keys.append(k)

    def noise(bi):
        initial, steps = jax_window_noise(keys[bi], 4, 34,
                                          jcfg.model.motion_dim, jgen._plain,
                                          False)
        return TableNoise({0: initial}, {(0, s, kind): v for (s, kind), v
                                         in steps.items()})
    got = tt.evaluate(TLoader(TDataset(cache), 4, shuffle=False),
                      noise=noise)
    assert np.isfinite(got.fgd) and np.isfinite(want.fgd)
    assert_metrics_close(got.as_dict(), want.as_dict(),
                         ("fgd", "mse", "pck", "pck2", "diversity"))
    # without the net FGD stays NaN
    plain = TTrainer(tcfg, str(tmp_path / "tw2"), device="cpu")
    load_flax_tree(plain.state.model, variables)
    assert np.isnan(plain.evaluate(TLoader(TDataset(cache), 4,
                                           shuffle=False),
                                   noise=noise).fgd)
