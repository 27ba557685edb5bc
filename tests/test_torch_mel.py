"""Port parity: the mel frontend's pieces (``audio/mel.py``) against JAX.

``frame_signal`` exactly; the filterbank (numpy float64 in both, cast to
float32) exactly, over fmin / fmax / the Slaney and HTK scales / Slaney
and no normalisation; ``stft_magsq`` centred (reflect and constant pads)
and uncentred, and ``MelFrontend`` with and without ``drop_last``, within
the mel bound of ``test_torch_pipeline.py`` (the FFT implementations
differ: max-abs <= 2e-5 of the spectrogram's scale).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")


def _audio(n, seed=0, batch=1):
    t = np.arange(n) / 18000.0
    rng = np.random.RandomState(seed)
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.1 * rng.randn(batch, n)).astype(np.float32)


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= 2e-5 * np.abs(ref).max()


@pytest.mark.parametrize("n,frame,hop", [(5000, 2048, 1200), (4096, 2048, 600),
                                         (900, 400, 320)])
def test_frame_signal(n, frame, hop):
    from diffsheg_tpu.audio.mel import frame_signal as jf
    from diffsheg_tpu_torch.audio.mel import frame_signal as pf
    y = _audio(n, batch=2)
    np.testing.assert_array_equal(pf(torch.tensor(y), frame, hop).numpy(),
                                  np.asarray(jf(jnp.asarray(y), frame, hop)))


@pytest.mark.parametrize("kw", [
    dict(), dict(fmin=80.0), dict(fmax=7600.0), dict(fmin=20.0, fmax=4000.0),
    dict(htk=True), dict(htk=True, fmin=60.0, fmax=8000.0), dict(norm=None),
    dict(htk=True, norm=None)],
    ids=["slaney", "fmin", "fmax", "fmin-fmax", "htk", "htk-band",
         "no-norm", "htk-no-norm"])
def test_mel_filterbank(kw):
    from diffsheg_tpu.audio.mel import mel_filterbank as jm
    from diffsheg_tpu_torch.audio.mel import mel_filterbank as pm
    for sr, n_fft, n_mels in ((18000, 2048, 128), (16000, 512, 40)):
        got, ref = pm(sr, n_fft, n_mels, **kw), jm(sr, n_fft, n_mels, **kw)
        assert got.dtype == np.float32 and got.shape == (n_mels, n_fft // 2 + 1)
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="norm"):
        pm(18000, 2048, 128, norm="l2")


@pytest.mark.parametrize("center,pad_mode", [(True, "reflect"),
                                             (True, "constant"),
                                             (False, "reflect")])
def test_stft_magsq(center, pad_mode):
    from diffsheg_tpu.audio.mel import hann_window
    from diffsheg_tpu.audio.mel import stft_magsq as js
    from diffsheg_tpu_torch.audio.mel import stft_magsq as ps
    y = _audio(18000 + 517, seed=1, batch=2)
    w = hann_window(2048)
    ref = js(jnp.asarray(y), 2048, 1200, jnp.asarray(w), center=center,
             pad_mode=pad_mode, use_matmul_dft=False)
    got = ps(torch.tensor(y), 2048, 1200, torch.tensor(w), center=center,
             pad_mode=pad_mode)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("drop_last", [True, False])
def test_mel_frontend(drop_last):
    from diffsheg_tpu.audio.mel import MelFrontend as JM
    from diffsheg_tpu_torch.audio.mel import MelFrontend as PM
    y = _audio(18000 * 2 + 300, seed=2)
    ref = JM(sr=18000, hop=1200, drop_last=drop_last)(jnp.asarray(y))
    got = PM(sr=18000, hop=1200, drop_last=drop_last, device="cpu")(
        torch.tensor(y))
    assert got.shape[1] == 30 + (not drop_last)
    _close(got.numpy(), ref)
