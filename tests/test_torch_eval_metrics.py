"""The evaluation metrics this slice adds to the port
(``diffsheg_tpu_torch/eval/metrics.py``: SRGR, multimodality, distance
matrices, R-precision, kinematic beats, beat alignment, scipy's Frechet
path; ``audio/onsets.py``) against the JAX package's: equal to 1e-12
(both sides numpy / scipy), the onset times through the port's mel equal
to JAX's."""

import numpy as np
import pytest

from diffsheg_tpu.audio import onsets as jons
from diffsheg_tpu.eval import metrics as jm
from diffsheg_tpu_torch.audio import onsets as tons
from diffsheg_tpu_torch.eval import metrics as tm
from torch_parity import mel_close

TOL = 1e-12


@pytest.mark.parametrize("avg_weight", [None, 0.165])
@pytest.mark.parametrize("annotated", [True, False])
def test_srgr_matches_jax(avg_weight, annotated):
    rng = np.random.RandomState(0)
    out, gt = rng.randn(50, 141) * 0.2, rng.randn(50, 141) * 0.2
    sem = rng.rand(50) * annotated
    want = jm.srgr(out, gt, sem, avg_weight=avg_weight)
    got = tm.srgr(out, gt, sem, avg_weight=avg_weight)
    assert abs(got - want) <= TOL and (want > 0 or not annotated)
    with pytest.raises(ValueError):
        tm.srgr(out[:, :140], gt[:, :140], sem)


def test_distances_multimodality_r_precision_match_jax():
    rng = np.random.RandomState(1)
    a, b = rng.randn(20, 16), rng.randn(20, 16) + 0.1 * rng.randn(20, 16)
    np.testing.assert_allclose(tm.euclidean_distance_matrix(a, b),
                               jm.euclidean_distance_matrix(a, b), atol=TOL)
    near = a + 0.05 * rng.randn(20, 16)
    for top_k in (1, 3):
        np.testing.assert_array_equal(tm.r_precision(a, near, top_k),
                                      jm.r_precision(a, near, top_k))
    for seed in (None, 4):
        r1 = None if seed is None else np.random.RandomState(seed)
        r2 = None if seed is None else np.random.RandomState(seed)
        assert abs(tm.multimodality(a, 8, r1) - jm.multimodality(a, 8, r2)) \
            <= TOL


def test_frechet_scipy_matches_jax():
    rng = np.random.RandomState(2)
    x, y = rng.randn(40, 6), rng.randn(40, 6) * 1.2 + 0.3
    args = tm.activation_statistics(x) + tm.activation_statistics(y)
    got, want = tm.frechet_distance_scipy(*args), jm.frechet_distance_scipy(
        *args)
    assert abs(got - want) <= TOL * max(1.0, abs(want))
    # the rank-deficient case takes the eps-offset retry in both
    few = tm.activation_statistics(x[:3]) + tm.activation_statistics(y[:3])
    assert abs(tm.frechet_distance_scipy(*few)
               - jm.frechet_distance_scipy(*few)) <= 1e-9
    # and the eigendecomposition path agrees with it
    assert abs(tm.frechet_distance(*args) - want) <= 1e-8 * abs(want)


@pytest.mark.parametrize("order", [3, 7])
def test_kinematic_beats_and_alignment_match_jax(order):
    rng = np.random.RandomState(3)
    motion = np.cumsum(rng.randn(120, 9), axis=0)
    np.testing.assert_array_equal(tm.kinematic_beats(motion, order),
                                  jm.kinematic_beats(motion, order))
    beats = np.sort(rng.rand(12) * 8.0)
    got = tm.beat_alignment(motion, beats, 15.0, order=order)
    assert got > 0 and abs(
        got - jm.beat_alignment(motion, beats, 15.0, order=order)) <= TOL
    assert tm.beat_alignment(motion, np.zeros(0), 15.0) == 0.0


def click_track(sr=16000, secs=4.0, clicks=(0.5, 1.25, 2.0, 2.75, 3.5)):
    y = (np.random.RandomState(4).randn(int(sr * secs)) * 1e-4
         ).astype(np.float32)
    for c in clicks:
        i = int(c * sr)
        t = np.arange(400)
        y[i:i + 400] += (np.sin(2 * np.pi * 1000 * t / sr)
                         * np.exp(-t / 80)).astype(np.float32)
    return y


def test_onset_pieces_match_jax():
    rng = np.random.RandomState(5)
    mel = np.abs(rng.randn(200, 64)) ** 3
    np.testing.assert_array_equal(tons.power_to_db(mel), jons.power_to_db(mel))
    for shift in (0, 1):
        np.testing.assert_array_equal(tons.onset_strength(mel, 1, shift),
                                      jons.onset_strength(mel, 1, shift))
    env = tons.onset_strength(mel)
    np.testing.assert_array_equal(tons.peak_pick(env, 1, 2, 2, 3, 0.5, 2),
                                  jons.peak_pick(env, 1, 2, 2, 3, 0.5, 2))
    for hop_s in (0.01, 1 / 15):
        np.testing.assert_array_equal(tons.pick_onsets(env, hop_s),
                                      jons.pick_onsets(env, hop_s))
    assert len(tons.pick_onsets(np.zeros(0), 0.01)) == 0
    # a precomputed mel needs its hop
    np.testing.assert_array_equal(
        tons.audio_onset_times(None, 16000, mel=mel, hop=160),
        jons.audio_onset_times(None, 16000, mel=mel, hop=160))
    with pytest.raises(ValueError, match="hop"):
        tons.audio_onset_times(None, 16000, mel=mel)


def test_audio_onset_times_matches_jax():
    import jax.numpy as jnp
    from diffsheg_tpu.audio.mel import MelFrontend as JMel
    from diffsheg_tpu_torch.audio.mel import MelFrontend as TMel
    y = click_track()
    kw = dict(sr=16000, n_fft=512, hop=160, n_mels=64, drop_last=True)
    mel_close(TMel(device="cpu", **kw)(y[None])[0].numpy(),
              np.asarray(JMel(**kw)(jnp.asarray(y)[None]))[0])
    got = tons.audio_onset_times(y, 16000, device="cpu")
    want = jons.audio_onset_times(y, 16000)
    np.testing.assert_allclose(got, want, atol=1e-9)
    for c in (0.5, 1.25, 2.0, 2.75, 3.5):
        assert np.min(np.abs(got - c)) < 0.05
