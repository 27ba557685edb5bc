"""Port parity: the motion exporter and what it stands on.

- ``BeatMotionExporter`` (CPU) against JAX's on the same normalized
  motion, statistics and template: the same files; npy and face JSON
  equal bit for bit (both de-normalize in numpy); BVH numbers parsed back
  within 1e-3 degrees (the euler conversion is f32 in both, the text
  ``%.6f``); the ``remove_hand`` 33-channel subset; no template -> no
  BVH; ``player=True`` writes the HTML player JAX's player code writes
  from the same BVH;
- the dataset statistics (``BeatStats``, ``ShowStats``) and SHOW's
  channel carpentry, equal to JAX's;
- ``CustomAudioPipeline.export_show`` against JAX's;
- ``utils/profiling``: the stage timer and a CPU ``torch.profiler`` trace.
"""

import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import beat_template_text  # noqa: E402


def _stats(seed, width=192):
    rng = np.random.RandomState(seed)
    return (rng.randn(width).astype(np.float32) * 0.3,
            (0.5 + rng.rand(width)).astype(np.float32))


def _exports(tmp_path, motion, mean, std, pose_dim=141, template=True,
             player=False):
    """The same export through JAX's and the port's exporter (CPU):
    (port files, JAX files)."""
    from diffsheg_tpu.sampling.export import BeatMotionExporter as JE
    from diffsheg_tpu_torch.sampling.export import BeatMotionExporter as PE
    tmpl = None
    if template:
        tmpl = str(tmp_path / "tmpl.bvh")
        with open(tmpl, "w") as f:
            f.write(beat_template_text(frames=1, seed=5))
    out = []
    for tag, cls, kw in (("port", PE, {"device": "cpu"}), ("jax", JE, {})):
        exp = cls(pose_dim, 15.0, mean, std, template_bvh=tmpl,
                  player=player, **kw)
        out.append(exp.export(motion, str(tmp_path / tag), "clip_0"))
    return out


def _bvh_frames(path):
    from diffsheg_tpu_torch.geometry.bvh import parse_bvh_file
    return parse_bvh_file(path).frames


def test_exporter_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    motion = rng.randn(45, 192).astype(np.float32)
    mean, std = _stats(1)
    port, ref = _exports(tmp_path, motion, mean, std)
    names = [os.path.basename(f) for f in port]
    assert names == [os.path.basename(f) for f in ref] == [
        "clip_0.npy", "clip_0.bvh", "clip_0_face.json"]
    np.testing.assert_array_equal(np.load(port[0]), np.load(ref[0]))
    np.testing.assert_array_equal(np.load(port[0]), motion * std + mean)
    assert open(port[2]).read() == open(ref[2]).read()
    got, want = _bvh_frames(port[1]), _bvh_frames(ref[1])
    assert got.shape == want.shape == (45, 228)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-3
    # the conversion's own output, before the text's rounding
    from diffsheg_tpu_torch.sampling.export import BeatMotionExporter as PE
    pe = PE(141, 15.0, mean, std, device="cpu")
    deg = pe.euler_degrees((motion * std + mean)[:, :141])
    assert deg.dtype == np.float32 and deg.shape == (45, 141)


def test_exporter_hand_free_subset(tmp_path):
    # a --remove_hand model emits 33 pose channels; the exporter selects
    # BEAT_HAND_FREE_CHANNELS ++ 141:192 from 192-wide stats and writes no
    # BVH even with a template
    from diffsheg_tpu.data.beat import BEAT_HAND_FREE_CHANNELS as J
    from diffsheg_tpu_torch.data.beat import BEAT_HAND_FREE_CHANNELS as P
    np.testing.assert_array_equal(P, J)
    rng = np.random.RandomState(2)
    motion = rng.randn(20, 84).astype(np.float32)
    mean, std = _stats(3)
    port, ref = _exports(tmp_path, motion, mean, std, pose_dim=33)
    assert [os.path.basename(f) for f in port] == [
        os.path.basename(f) for f in ref] == ["clip_0.npy", "clip_0_face.json"]
    sel = np.r_[J, np.arange(141, 192)]
    np.testing.assert_array_equal(np.load(port[0]), np.load(ref[0]))
    np.testing.assert_array_equal(np.load(port[0]),
                                  motion * std[sel] + mean[sel])
    assert open(port[1]).read() == open(ref[1]).read()


def test_exporter_without_template_skips_bvh(tmp_path):
    motion = np.zeros((10, 192), np.float32)
    port, ref = _exports(tmp_path, motion, np.zeros(192), np.ones(192),
                         template=False)
    assert [os.path.basename(f) for f in port] == [
        os.path.basename(f) for f in ref] == ["clip_0.npy", "clip_0_face.json"]
    np.testing.assert_array_equal(np.load(port[0]), np.load(ref[0]))
    with pytest.warns(UserWarning, match="no BVH was written"):
        _exports(tmp_path, motion, np.zeros(192), np.ones(192),
                 template=False, player=True)


def test_exporter_player_writes_html(tmp_path):
    from diffsheg_tpu.viz.player import export_bvh_player as jplayer
    from diffsheg_tpu_torch.viz.player import export_bvh_player
    rng = np.random.RandomState(4)
    motion = rng.randn(12, 192).astype(np.float32)
    mean, std = _stats(5)
    port, _ = _exports(tmp_path, motion, mean, std, player=True)
    assert [os.path.basename(f) for f in port] == [
        "clip_0.npy", "clip_0.bvh", "clip_0_face.json",
        "clip_0_player.html"]
    html = open(port[3]).read()
    want = jplayer(port[1], str(tmp_path / "j.html"), face_json=port[2])
    assert html == open(want).read()
    d = json.loads(re.search(r"const D = (\{.*?\});\n", html, re.S).group(1))
    assert len(d["positions"]) == 12 and len(d["face_names"]) == 51
    # the view command's stride
    out = export_bvh_player(port[1], str(tmp_path / "s.html"), stride=5)
    d = json.loads(re.search(r"const D = (\{.*?\});\n", open(out).read(),
                             re.S).group(1))
    assert len(d["positions"]) == 3 and d["face"] is None


def test_beat_and_show_stats_equal_jax(tmp_path):
    import diffsheg_tpu.data.beat as JB
    import diffsheg_tpu.data.show as JS
    import diffsheg_tpu_torch.data.beat as PB
    import diffsheg_tpu_torch.data.show as PS
    rng = np.random.RandomState(6)
    arrays = [rng.randn(n) for n in (141, 141, 141, 141, 51, 51)]
    PB.BeatStats(*arrays).save(str(tmp_path / "stats"))
    ps = PB.BeatStats.load(str(tmp_path / "stats"))
    js = JB.BeatStats.load(str(tmp_path / "stats"))
    np.testing.assert_array_equal(ps.motion_mean, js.motion_mean)
    np.testing.assert_array_equal(ps.motion_std, js.motion_std)
    np.testing.assert_array_equal(ps.mean_pose, arrays[0])
    raw = {"pose_mean": rng.randn(165), "pose_std": rng.rand(165) + 0.5,
           "expression_mean": rng.randn(100),
           "expression_std": rng.rand(100) + 0.5}
    np.save(tmp_path / "talkshow_mean_std.npy", raw, allow_pickle=True)
    ps = PS.ShowStats.load(str(tmp_path / "talkshow_mean_std.npy"))
    js = JS.ShowStats.load(str(tmp_path / "talkshow_mean_std.npy"))
    for k in ("pose_mean", "pose_std", "expression_mean", "expression_std",
              "motion_mean", "motion_std"):
        np.testing.assert_array_equal(getattr(ps, k), getattr(js, k))
    pose = rng.randn(4, 165)
    np.testing.assert_array_equal(PS.extract_gesture(pose),
                                  JS.extract_gesture(pose))
    x = rng.randn(4, 232)
    np.testing.assert_array_equal(
        PS.inv_standardize(PS.standardize(x, ps.motion_mean, ps.motion_std),
                           ps.motion_mean, ps.motion_std),
        JS.inv_standardize(JS.standardize(x, js.motion_mean, js.motion_std),
                           js.motion_mean, js.motion_std))


def test_export_show_matches_jax(tmp_path):
    from diffsheg_tpu.cli.generate import CustomAudioPipeline as JP
    from diffsheg_tpu.data.show import ShowStats as JS
    from diffsheg_tpu_torch.cli.generate import CustomAudioPipeline as PP
    from diffsheg_tpu_torch.data.show import ShowStats as PS
    rng = np.random.RandomState(7)
    raw = {"pose_mean": rng.randn(165), "pose_std": rng.rand(165) + 0.5,
           "expression_mean": rng.randn(100),
           "expression_std": rng.rand(100) + 0.5}
    motion = rng.randn(2, 30, 232).astype(np.float32)
    # export_show uses no pipeline state
    got = PP.export_show(None, motion, str(tmp_path / "p"), "c",
                         stats=PS.from_raw_dict(raw))
    want = JP.export_show(None, motion, str(tmp_path / "j"), "c",
                          stats=JS.from_raw_dict(raw))
    assert [os.path.basename(f) for f in got] == [
        os.path.basename(f) for f in want] == ["c_0.npy", "c_1.npy"]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.load(a), np.load(b))
    plain = PP.export_show(None, motion, str(tmp_path / "n"), "c")
    np.testing.assert_array_equal(np.load(plain[1]), motion[1])


def test_stage_timer_and_device_trace(tmp_path):
    from diffsheg_tpu_torch.utils.profiling import (StageTimer,
                                                    block_until_ready,
                                                    device_trace)
    timer = StageTimer()
    with timer.stage("a"):
        x = torch.ones(4) * 2
    with timer.stage("a"):
        pass
    with timer.stage("b"):
        block_until_ready({"x": [x, (x,)]})
    rep = timer.report()
    assert set(rep) == {"a", "b", "total"}
    assert rep["total"] == pytest.approx(rep["a"] + rep["b"])
    assert timer.fps(30) == pytest.approx(30 / timer.total)
    assert timer.rtf(30, 15) == pytest.approx(2 / timer.total)
    with device_trace(None):
        pass
    with device_trace(str(tmp_path / "trace")):
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    assert any(n.endswith(".json") or n.endswith(".json.gz")
               for n in os.listdir(tmp_path / "trace"))
