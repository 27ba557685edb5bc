"""Dataset caches from raw data: the port's builders
(``diffsheg_tpu_torch/data/{beat,show_cache,beat_preprocess}.py``,
``runtime``, ``audio/mfcc.py``) against the JAX package's on synthetic
splits.  Caches equal field for field: mel and mfcc within 2e-5 of
scale, axis-angle within 1e-4 through the rebuilt rotation matrices (it
is ill-conditioned near pi; compared de-normalized), everything else bit
for bit; the statistics equal (the axis-angle ones to float32
round-off); each package's dataset reads the other's cache."""

import os

import jax
import numpy as np
import pytest
import torch

from diffsheg_tpu import runtime as jruntime
from diffsheg_tpu.audio import mfcc as jmfcc
from diffsheg_tpu.data import beat as jbeat
from diffsheg_tpu.data import beat_preprocess as jpre
from diffsheg_tpu.data import show as jshow
from diffsheg_tpu.data import show_cache as jshowc
from diffsheg_tpu_torch import runtime as truntime
from diffsheg_tpu_torch.audio import mfcc as tmfcc
from diffsheg_tpu_torch.data import beat as tbeat
from diffsheg_tpu_torch.data import beat_preprocess as tpre
from diffsheg_tpu_torch.data import show as tshow
from diffsheg_tpu_torch.data import show_cache as tshowc
from diffsheg_tpu_torch.data.cache import ArrayCache
from torch_parity import mel_close, write_beat_split, write_show_split

CPU = torch.device("cpu")
QUIET = dict(log=lambda *a: None)
CLIPS = {"2_scott_0_1_1": dict(secs=6, labels=True),
         # pose one frame short of 6 s: every modality clamps to 5 s
         "4_lawrence_0_2_2": dict(secs=7, pose_secs=6 - 1 / 15),
         # session "b": its annotation is offset by 30 s
         "6_carla_0_4_4_b": dict(secs=5),
         # every window equal to the mean pose below: filtered
         "8_dan_0_3_3": dict(secs=4, const=5.0)}


@pytest.fixture(scope="module")
def beat_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("beat")
    write_beat_split(root / "train", CLIPS, seed=0)
    write_beat_split(root / "test", {"2_scott_0_9_9": dict(secs=5),
                                     "10_kieks_0_9_9": dict(secs=4)}, seed=1)
    return root


def _stats(root):
    stats = jbeat.compute_beat_stats(str(root / "train"), **QUIET)
    stats.mean_pose = np.full_like(stats.mean_pose, 5.0)
    return stats


def assert_aa_close(a, b):
    """Axis-angle through the rebuilt matrices, within 1e-4."""
    from diffsheg_tpu_torch.geometry.rotations import axis_angle_to_matrix
    ma = axis_angle_to_matrix(torch.tensor(np.reshape(a, (-1, 3))))
    mb = axis_angle_to_matrix(torch.tensor(np.reshape(b, (-1, 3))))
    assert float((ma - mb).abs().max()) <= 1e-4


def assert_caches_match(port_dir, jax_dir, port_stats=None, jax_stats=None):
    P, J = ArrayCache(str(port_dir)), ArrayCache(str(jax_dir))
    assert P.fields == J.fields and len(P) == len(J) and P.meta == J.meta
    for i in range(len(J)):
        p, j = P[i], J[i]
        for k in J.fields:
            assert p[k].dtype == j[k].dtype and p[k].shape == j[k].shape, k
            if k in ("mel", "mfcc"):
                mel_close(p[k], j[k])
            elif k == "pose_axis_angle":
                ps, js = port_stats or jax_stats, jax_stats
                assert_aa_close(p[k] * ps.std_axis_angle + ps.mean_axis_angle,
                                j[k] * js.std_axis_angle + js.mean_axis_angle)
            else:
                np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    return len(J)


@pytest.mark.parametrize("split", ["train", "test"])
def test_beat_cache_matches_jax(beat_root, tmp_path, split):
    stats = _stats(beat_root)
    kw = dict(is_test=split == "test", **QUIET)
    n_j = jbeat.build_beat_cache(str(beat_root / split), str(tmp_path / "j"),
                                 stats, **kw)
    n_p = tbeat.build_beat_cache(str(beat_root / split), str(tmp_path / "p"),
                                 stats, device=CPU, **kw)
    assert n_p == n_j == assert_caches_match(tmp_path / "p", tmp_path / "j",
                                             jax_stats=stats)
    c = ArrayCache(str(tmp_path / "p"))
    if split == "train":
        # 6 s, 5 s (clamped) and 5 s clips of 34-frame windows every 10;
        # the constant clip's windows all filtered
        assert n_p == 6 + 5 + 5
        assert c.meta["n_poses"] == 34 and not c.meta["is_test"]
        ids = np.unique(c.gather("id", np.arange(n_p)))
        assert ids.tolist() == [1, 3, 5]
        # labels where the split has them, the -1 sentinel elsewhere
        word = c.gather("word", np.arange(n_p))
        assert (word[:6] >= 0).all() and (word[6:] == -1).all()
        # the "b" session's 31-33 s annotation lands at 1-3 s of the clip
        sem = c.gather("sem", np.arange(n_p))
        assert np.isclose(sem[11:], 0.4).any()
    else:
        # whole clips, stored ragged
        assert n_p == 2 and c.meta["is_test"]
        assert [c[i]["pose"].shape[0] for i in range(2)] == [60, 75]


def test_beat_stats_match_jax(beat_root):
    j = jbeat.compute_beat_stats(str(beat_root / "train"), **QUIET)
    p = tbeat.compute_beat_stats(str(beat_root / "train"), device=CPU,
                                 **QUIET)
    for f in ("mean_pose", "std_pose", "mean_facial", "std_facial"):
        np.testing.assert_array_equal(getattr(p, f), getattr(j, f), f)
    for f in ("mean_axis_angle", "std_axis_angle"):
        np.testing.assert_allclose(getattr(p, f), getattr(j, f), rtol=1e-6,
                                   atol=1e-6, err_msg=f)


@pytest.mark.parametrize("reader", ["jax", "port"])
def test_datasets_read_each_others_caches(beat_root, tmp_path, reader):
    stats = _stats(beat_root)
    built = {"jax": jbeat.build_beat_cache, "port": tbeat.build_beat_cache}
    other = "port" if reader == "jax" else "jax"
    kw = dict(device=CPU) if other == "port" else {}
    built[other](str(beat_root / "train"), str(tmp_path / "c"), stats,
                 **QUIET, **kw)
    jds = jbeat.BeatDataset(str(tmp_path / "c"))
    tds = tbeat.BeatDataset(str(tmp_path / "c"))
    idx = np.array([3, 0, 11])
    a, b = (jds, tds) if reader == "jax" else (tds, jds)
    got, want = a.batch(idx), b.batch(idx)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, v in b[5].items():
        np.testing.assert_array_equal(a[5][k], v, err_msg=k)


@pytest.mark.parametrize("split", ["train", "test"])
def test_show_cache_matches_jax(tmp_path, split):
    # the third sequence is shorter than a window: skipped in train
    root = write_show_split(tmp_path / "show", [130, 100, 60], seed=2)
    kw = dict(is_test=split == "test", **QUIET)
    n_j = jshowc.build_show_cache(jshowc.iter_npz_dir(root),
                                  str(tmp_path / "j"), **kw)
    n_p = tshowc.build_show_cache(tshowc.iter_npz_dir(root),
                                  str(tmp_path / "p"), device=CPU, **kw)
    assert n_p == n_j == assert_caches_match(tmp_path / "p", tmp_path / "j")
    assert n_p == (3 if split == "test" else 5 + 2)
    js = jshowc.compute_show_stats(jshowc.iter_npz_dir(root))
    ps = tshowc.compute_show_stats(tshowc.iter_npz_dir(root))
    assert sorted(ps) == sorted(js)
    for k in js:
        np.testing.assert_array_equal(ps[k], js[k], err_msg=k)
    # ShowDataset reads it in both packages, mfcc from the field
    np.save(tmp_path / "talkshow_mean_std.npy", js, allow_pickle=True)
    st = str(tmp_path / "talkshow_mean_std.npy")
    jds = jshow.ShowDataset(str(tmp_path / "p"), jshow.ShowStats.load(st),
                            audio_feat="mfcc")
    tds = tshow.ShowDataset(str(tmp_path / "p"), tshow.ShowStats.load(st),
                            audio_feat="mfcc", device=CPU)
    for k, v in jds[1].items():
        np.testing.assert_array_equal(tds[1][k], v, err_msg=k)


def test_parse_frames_file_bit_equal(tmp_path):
    rng = np.random.RandomState(5)
    path = tmp_path / "f.bvh"
    np.savetxt(path, rng.randn(40, 141) * 25, fmt="%.6f")
    np.testing.assert_array_equal(truntime.parse_frames_file(str(path)),
                                  jruntime.parse_frames_file(str(path)))
    text = b"1e-3 -2.5E+02  7\n\n  0.1\t-0 3.14159265358979\n"
    (tmp_path / "g.txt").write_bytes(text)
    for a, b in zip(truntime.parse_float_text(text),
                    jruntime.parse_float_text(text)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        truntime.parse_frames_file(str(tmp_path / "g.txt")),
        jruntime.parse_frames_file(str(tmp_path / "g.txt")))
    np.testing.assert_array_equal(
        tbeat.parse_numeric_frames(str(path)),
        jbeat.parse_numeric_frames(str(path)))
    src = rng.randn(10, 3, 2)
    idx = np.array([4, 0, 9, 4])
    np.testing.assert_array_equal(truntime.gather_rows(src, idx),
                                  jruntime.gather_rows(src, idx))


@pytest.mark.parametrize("drop_last", [True, False])
def test_mfcc_matches_jax(drop_last):
    rng = np.random.RandomState(6)
    audio = (rng.randn(3, 18000) * 0.1).astype(np.float32)
    audio[1] *= 1e-4            # a quiet sample: its own top_db floor
    kw = dict(sr=18000, hop=600, n_mels=128, n_mfcc=64, drop_last=drop_last)
    want = np.asarray(jmfcc.MfccFrontend(**kw)(audio))
    got = tmfcc.MfccFrontend(device=CPU, **kw)(audio).numpy()
    assert got.shape == want.shape == (3, 30 + (not drop_last), 64)
    mel_close(got, want)
    np.testing.assert_array_equal(tmfcc.dct_ii_matrix(128, 64),
                                  jmfcc.dct_ii_matrix(128, 64))
    S = np.abs(rng.randn(2, 5, 7)).astype(np.float32) * [[[1.0]], [[1e-9]]]
    np.testing.assert_allclose(
        tmfcc.power_to_db(torch.tensor(S)).numpy(),
        np.asarray(jmfcc.power_to_db(jax.numpy.asarray(S))), rtol=1e-6,
        atol=1e-4)


def test_beat_preprocess_matches_jax(tmp_path):
    from torch_parity import beat_template_text
    src = tmp_path / "src"
    src.mkdir()
    # a 120 fps full-skeleton BVH
    text = beat_template_text(frames=17, seed=7).replace(
        "Frame Time: 0.06666667", "Frame Time: 0.00833333")
    (src / "a.bvh").write_text(text)
    np.testing.assert_array_equal(
        tpre.subselect_and_downsample(str(src / "a.bvh"))[0],
        jpre.subselect_and_downsample(str(src / "a.bvh"))[0])
    assert tpre.subselect_and_downsample(str(src / "a.bvh"))[1] == 15.0
    for mod, out in ((tpre, "p"), (jpre, "j")):
        assert mod.export_bvh_rot_dir(str(src), str(tmp_path / out),
                                      log=lambda *a: None) == 1
        mod.make_vis_template(str(src / "a.bvh"), str(tmp_path / f"{out}.bvh"))
    assert ((tmp_path / "p" / "a.bvh").read_text()
            == (tmp_path / "j" / "a.bvh").read_text())
    assert (tmp_path / "p.bvh").read_text() == (tmp_path / "j.bvh").read_text()
    p, j = tpre.channel_stats(str(tmp_path / "p")), jpre.channel_stats(
        str(tmp_path / "j"))
    for k in j:
        np.testing.assert_array_equal(p[k], j[k])


def test_cli_build_cache_then_train(tmp_path, capsys):
    from diffsheg_tpu_torch.cli.main import main
    root = tmp_path / "beat"
    write_beat_split(root / "train", {"2_a_0_1_1": dict(secs=4),
                                      "3_b_0_1_1": dict(secs=4)}, seed=3)
    stats, cache = str(tmp_path / "stats"), str(tmp_path / "cache")
    assert main(["build-cache", "--device", "cpu", "--data-root", str(root),
                 "--split", "train", "--stats-dir", stats,
                 "--out", cache]) == 0
    out = capsys.readouterr().out
    assert "computing dataset statistics" in out
    assert f"cache: 6 samples -> {cache}" in out
    assert os.path.exists(os.path.join(stats, "axis_angle_mean.npy"))
    # a second split reuses the statistics
    assert main(["build-cache", "--device", "cpu", "--data-root", str(root),
                 "--split", "train", "--stats-dir", stats,
                 "--out", cache + "2"]) == 0
    assert "computing" not in capsys.readouterr().out
    assert main(["train", "--device", "cpu", "--workdir",
                 str(tmp_path / "run"), "--train-cache", cache,
                 "--stats-dir", stats, "--epochs", "1",
                 "--set", "model.latent_dim=32", "--set", "model.num_layers=1",
                 "--set", "model.num_heads=2", "--set", "model.ff_size=64",
                 "--set", "model.add_hubert=false",
                 "--set", "train.batch_size=4",
                 "--set", "train.log_every=1"]) == 0
    recs = [line for line in open(tmp_path / "run" / "metrics.jsonl")
            if '"total"' in line]
    assert len(recs) == 1 and "NaN" not in recs[0]
    # SHOW: statistics file and a cache with the mfcc field
    write_show_split(tmp_path / "show" / "train", [100, 95], seed=4)
    sstats = str(tmp_path / "sstats")
    assert main(["build-cache", "--device", "cpu", "--dataset", "show",
                 "--data-root", str(tmp_path / "show"), "--stats-dir",
                 sstats]) == 0
    assert "show cache: 3 samples" in capsys.readouterr().out
    c = ArrayCache(str(tmp_path / "show" / "cache_train"))
    assert c.gather("mfcc", np.arange(3)).shape == (3, 88, 64)
    assert os.path.exists(os.path.join(sstats, "talkshow_mean_std.npy"))
