"""Port parity: geometry (rotations, quaternions, joints, BVH, face JSON)
and the temporal filter, against the JAX package on the same inputs.

- rotations and quaternions: every public function on seeded f32 inputs,
  <= 1e-5 absolute (unit-scale outputs; angles in radians);
- gimbal lock (the middle angle at and near +-90 degrees) and the zero
  rotation: no NaN or Inf, and where the angles are ill-conditioned the
  matrices rebuilt from each package's angles agree (<= 1e-5 from the
  same matrix; <= 1e-4 through the exporter's axis-angle path, whose
  intermediate matrices differ by f32 ulps that the split amplifies);
- joints, BVH and face JSON are numpy in both packages: bit-equal;
- ``motion_temporal_filter`` <= 1e-6 absolute.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import beat_template_text  # noqa: E402

TOL = 1e-5
CONVENTIONS = ["XYZ", "XZY", "YXZ", "YZX", "ZXY", "ZYX",
               "XYX", "XZX", "YXY", "YZY", "ZXZ", "ZYZ"]
ORDERS = ["xyz", "yzx", "zxy", "xzy", "yxz", "zyx"]


def _pair(name, module="rotations"):
    import importlib
    j = importlib.import_module(f"diffsheg_tpu.geometry.{module}")
    p = importlib.import_module(f"diffsheg_tpu_torch.geometry.{module}")
    return getattr(j, name), getattr(p, name)


def _both(name, *args, module="rotations", **kw):
    """(port, JAX) outputs of ``name`` on the same f32 numpy inputs."""
    jf, pf = _pair(name, module)
    j = np.asarray(jf(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                        for a in args), **kw))
    p = pf(*(torch.tensor(a) if isinstance(a, np.ndarray) else a
             for a in args), **kw).numpy()
    return p, j


def _close(name, *args, tol=TOL, module="rotations", **kw):
    p, j = _both(name, *args, module=module, **kw)
    assert p.shape == j.shape and p.dtype == j.dtype == np.float32
    assert np.isfinite(p).all()
    err = np.abs(p - j).max()
    assert err <= tol, (name, err)
    return p


def _f32(a):
    return np.asarray(a, np.float32)


def _euler(n, seed, kind=None):
    """Random euler radians; the middle angle inside (-1.2, 1.2) for a
    Tait-Bryan order, inside (0.3, 2.8) for a proper one (away from
    gimbal lock)."""
    rng = np.random.RandomState(seed)
    e = rng.uniform(-3.0, 3.0, (n, 3))
    e[:, 1] = rng.uniform(-1.2, 1.2, n) if kind == "tb" else \
        rng.uniform(0.3, 2.8, n)
    return _f32(e)


def _aa(n, seed):
    rng = np.random.RandomState(seed)
    axis = rng.randn(n, 3)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    return _f32(axis * rng.uniform(0.05, 3.0, (n, 1)))


def _quat(n, seed):
    q = np.random.RandomState(seed).randn(n, 4)
    return _f32(q / np.linalg.norm(q, axis=-1, keepdims=True))


def _rotmat(n, seed):
    from scipy.spatial.transform import Rotation
    return _f32(Rotation.random(n, random_state=seed).as_matrix())


# -- rotations ---------------------------------------------------------------

@pytest.mark.parametrize("conv", CONVENTIONS)
def test_euler_matrix_both_ways(conv):
    tb = conv[0] != conv[2]
    e = _euler(64, 1, "tb" if tb else None)
    m = _close("euler_to_matrix", e, conv)
    _close("matrix_to_euler", m, conv)
    _close("euler_to_axis_angle", e, conv)


@pytest.mark.parametrize("name,maker", [
    ("matrix_to_quaternion", _rotmat), ("matrix_to_axis_angle", _rotmat),
    ("quaternion_to_matrix", _quat), ("quaternion_to_axis_angle", _quat),
    ("axis_angle_to_quaternion", _aa), ("axis_angle_to_matrix", _aa),
    ("axis_angle_to_euler", _aa)])
def test_rotation_conversions(name, maker):
    _close(name, maker(128, 2))


def test_matrix_to_quaternion_every_dominant_component():
    # each of w, x, y, z largest in turn (180-degree turns about each axis
    # and the identity), plus a tie between two components
    mats = [np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
            np.diag([-1.0, -1.0, 1.0])]
    c, s = np.cos(np.pi / 2), np.sin(np.pi / 2)
    mats.append(np.array([[1, 0, 0], [0, c, -s], [0, s, c]]))
    q = _close("matrix_to_quaternion", _f32(mats))
    assert (q[:, 0] >= 0).all()


def _rebuilt(euler):
    """Intrinsic XYZ euler radians -> rotation matrices (float64, scipy)."""
    from scipy.spatial.transform import Rotation
    return Rotation.from_euler("XYZ", np.asarray(euler, np.float64)).as_matrix()


def _lock_matrices(mids):
    return _f32(_rebuilt([(a, mid, c) for mid in mids
                          for a, c in ((0.3, -0.7), (1.1, 0.4), (-2.0, 2.5))]))


def test_gimbal_lock_and_zero_rotation():
    # at and near lock the split between the first and third angle is
    # ill-conditioned: compare the matrices rebuilt from the angles
    half = np.pi / 2
    m = _lock_matrices((half, -half, half - 1e-4, -half + 1e-3))
    p, j = _both("matrix_to_euler", m, "XYZ")
    assert np.isfinite(p).all() and np.isfinite(j).all()
    assert np.abs(_rebuilt(p) - _rebuilt(j)).max() <= TOL
    # the exporter's path (axis-angle -> matrix -> euler) near lock: the
    # intermediate matrices agree to a few f32 ulps, which the split
    # amplifies by ~1 / cos(middle angle) (20-100 here): the rebuilt
    # rotations agree within 1e-4, as each does with the input
    m = _lock_matrices((half - 1e-2, -half + 1e-2, half - 5e-2))
    aa = _close("matrix_to_axis_angle", m)
    _close("axis_angle_to_matrix", aa, tol=1e-6)
    p, j = _both("axis_angle_to_euler", aa, "XYZ")
    for r in (_rebuilt(p), _rebuilt(j)):
        assert np.abs(r - m).max() <= 1e-4
    assert np.abs(_rebuilt(p) - _rebuilt(j)).max() <= 1e-4
    # exactly at lock the rebuilt rotation is the algorithm's own guess in
    # both packages (the first and third angle come from f32 round-off);
    # what holds is that nothing overflows
    aa = _close("matrix_to_axis_angle", _lock_matrices((half, -half)))
    p, j = _both("axis_angle_to_euler", aa, "XYZ")
    assert np.isfinite(p).all() and np.isfinite(j).all()
    # zero rotations: the small-angle branches give zeros, no NaN
    zero = np.zeros((4, 3), np.float32)
    for name, x in (("axis_angle_to_euler", zero),
                    ("axis_angle_to_quaternion", zero),
                    ("quaternion_to_axis_angle",
                     _f32([[1, 0, 0, 0]] * 3 + [[1, 1e-9, 0, 0]])),
                    ("matrix_to_axis_angle", _f32([np.eye(3)] * 2))):
        out = _close(name, x)
        assert np.isfinite(out).all()
    tiny = _f32(np.random.RandomState(3).randn(8, 3) * 1e-7)
    _close("axis_angle_to_quaternion", tiny)
    _close("axis_angle_to_euler", tiny)


# -- quaternions --------------------------------------------------------------

def test_quaternion_algebra():
    q, r = _quat(64, 4), _quat(64, 5)
    v = _f32(np.random.RandomState(6).randn(64, 3))
    for name, args in (("qnormalize", (q * 2.5,)), ("qmul", (q, r)),
                       ("qinv", (q,)), ("qrot", (q, v)),
                       ("qbetween", (v, _f32(np.roll(v, 1, 0)))),
                       ("quaternion_to_cont6d", (q,)),
                       ("axis_angle_to_quaternion", (_aa(64, 7),)),
                       ("quaternion_to_axis_angle", (q,)),
                       ("expmap_to_quaternion", (_aa(64, 8),)),
                       ("expmap_to_quaternion", (np.zeros((2, 3), np.float32),))):
        _close(name, *args, module="quaternion")
    c6 = _f32(np.random.RandomState(9).randn(64, 6))
    _close("cont6d_to_matrix", c6, module="quaternion")
    _close("matrix_to_cont6d", _rotmat(32, 10), module="quaternion")
    # broadcasting against one quaternion, as qrot is called on joints
    _close("qrot", q[:1], v, module="quaternion")


@pytest.mark.parametrize("order", ORDERS)
def test_qeuler_and_euler_to_quaternion(order):
    _close("qeuler", _quat(64, 11), order, module="quaternion")
    _close("qeuler", _quat(64, 12), order, 1e-6, module="quaternion")
    e = _f32(np.random.RandomState(13).uniform(-170, 170, (64, 3)))
    _close("euler_to_quaternion", e, order, degrees=True,
           module="quaternion")
    _close("euler_to_quaternion", np.deg2rad(e).astype(np.float32), order,
           module="quaternion")


def test_qslerp_qfix_qpow():
    q0, q1 = _quat(32, 14), _quat(32, 15)
    for t in (0.0, 0.3, 1.0):
        _close("qslerp", q0, q1, t, module="quaternion")
    _close("qslerp", q0, q0, 0.5, module="quaternion")     # sin(theta) ~ 0
    _close("qslerp", q0, q1, _f32(np.linspace(0, 1, 32))[:, None],
           module="quaternion")
    seq = _quat(40, 16).reshape(10, 4, 4)
    seq[1::3] *= -1
    _close("qfix", seq, module="quaternion")
    _close("qpow", q0, 0.5, module="quaternion", tol=1e-4)
    _close("qpow", q0, _f32(np.linspace(-1, 2, 32)), module="quaternion",
           tol=1e-4)
    _close("qpow", _f32([[1, 0, 0, 0]]), 0.7, module="quaternion")


# -- joints, BVH, face: the port's own numpy copies -------------------------

def test_joint_tables_equal_jax():
    import diffsheg_tpu.geometry.joints as J
    import diffsheg_tpu_torch.geometry.joints as P
    for name in ("BEAT_JOINT_ORDER", "SPINE_NECK_141_ORDER", "BEAT_CHANNELS",
                 "BEAT_TOTAL_CHANNELS", "N_SPINE_NECK_JOINTS",
                 "SPINE_NECK_DIM"):
        assert getattr(P, name) == getattr(J, name), name
    np.testing.assert_array_equal(P.SPINE_NECK_141_IN_BEAT,
                                  J.SPINE_NECK_141_IN_BEAT)
    sub = ("Spine", "RArm", "LHandT3")
    np.testing.assert_array_equal(P.subset_channel_indices(sub),
                                  J.subset_channel_indices(sub))
    rng = np.random.RandomState(0)
    frames, rest = rng.randn(7, 141), rng.randn(228)
    np.testing.assert_array_equal(P.scatter_subset_into_full(frames, rest),
                                  J.scatter_subset_into_full(frames, rest))
    assert P.channel_table(("a", "b"), 3) == J.channel_table(("a", "b"), 3)


def test_bvh_parse_write_fk_rewrite_equal_jax(tmp_path):
    import diffsheg_tpu.geometry.bvh as J
    import diffsheg_tpu_torch.geometry.bvh as P
    text = beat_template_text()
    pd, jd = P.parse_bvh(text), J.parse_bvh(text)
    np.testing.assert_array_equal(pd.frames, jd.frames)
    assert pd.frame_time == jd.frame_time and pd.names == jd.names
    for a, b in zip(pd.joints, jd.joints):
        assert (a.name, a.parent, a.channels, a.channel_start, a.is_end_site
                ) == (b.name, b.parent, b.channels, b.channel_start,
                      b.is_end_site)
        np.testing.assert_array_equal(a.offset, b.offset)
        assert pd.rotation_order(a) == jd.rotation_order(b)
    assert P.write_bvh(pd) == J.write_bvh(jd)
    np.testing.assert_array_equal(P.forward_kinematics(pd),
                                  J.forward_kinematics(jd))
    gen = np.random.RandomState(1).uniform(-90, 90, (6, 141))
    assert P.rewrite_template(text, gen) == J.rewrite_template(text, gen)
    (tmp_path / "t.bvh").write_text(text)
    P.rewrite_template_file(str(tmp_path / "t.bvh"), gen,
                            str(tmp_path / "p.bvh"))
    J.rewrite_template_file(str(tmp_path / "t.bvh"), gen,
                            str(tmp_path / "j.bvh"))
    assert (tmp_path / "p.bvh").read_text() == (tmp_path / "j.bvh").read_text()
    back = P.parse_bvh_file(str(tmp_path / "p.bvh"))
    assert back.frames.shape == (6, 228)


def test_face_json_equal_jax(tmp_path):
    import diffsheg_tpu.geometry.face as J
    import diffsheg_tpu_torch.geometry.face as P
    assert P.ARKIT_FACIAL_51 == J.ARKIT_FACIAL_51
    rng = np.random.RandomState(2)
    w, mean, std = rng.rand(9, 51), rng.rand(51), rng.rand(51) + 0.5
    P.write_face_json(w, str(tmp_path / "p.json"), fps=15, mean=mean, std=std)
    J.write_face_json(w, str(tmp_path / "j.json"), fps=15, mean=mean, std=std)
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    face = json.loads((tmp_path / "p.json").read_text())
    assert len(face["names"]) == 51 and len(face["frames"]) == 9
    np.testing.assert_array_equal(
        P.read_face_json(str(tmp_path / "p.json"), mean, std),
        J.read_face_json(str(tmp_path / "j.json"), mean, std))
    assert P.face_frames_dict(w, 30.0) == J.face_frames_dict(w, 30.0)


def test_geometry_package_reexports():
    import diffsheg_tpu.geometry as J
    import diffsheg_tpu_torch.geometry as P
    names = [n for n in dir(J) if not n.startswith("_")
             and n not in ("rotations", "joints", "bvh", "face")]
    assert names and all(hasattr(P, n) for n in names)


# -- the temporal filter ------------------------------------------------------

@pytest.mark.parametrize("shape,sigma", [((40, 6), 2.5), ((2, 3, 30, 5), 1.0),
                                         ((9, 4), 3.0)])
def test_motion_temporal_filter(shape, sigma):
    from diffsheg_tpu.utils.filters import gaussian_kernel1d as jk
    from diffsheg_tpu.utils.filters import motion_temporal_filter as jf
    from diffsheg_tpu_torch.utils.filters import gaussian_kernel1d as pk
    from diffsheg_tpu_torch.utils.filters import motion_temporal_filter as pf
    np.testing.assert_array_equal(pk(sigma), jk(sigma))
    x = _f32(np.random.RandomState(17).randn(*shape))
    ref = np.asarray(jf(jnp.asarray(x), sigma))
    got = pf(torch.from_numpy(x), sigma).numpy()
    assert got.shape == ref.shape == shape
    assert np.abs(got - ref).max() <= 1e-6
