"""Port parity: the live session (``sampling/live.py``) and the host-loop
streamer (``StreamingGenerator.generate``) against the JAX package.

The cases of ``tests/test_live.py``, each run through the JAX
``LiveSession`` and the port's on the same weights, audio and noise
(``ChainNoise`` replays the session's key chain, ``rng, k = split(rng)``
a window; a session too short for a window draws from the unsplit key).
JAX runs its generator on the CPU (its Flax path); the port runs the fast
path's plain versions.  Samples of a random model reach
~1e5, so the bound is relative, as in ``test_torch_pipeline.py``: rel-RMS
<= 1e-4 and max-abs <= 1e-4 of max |ref|.  The port's session against the
port's offline host loop is held no looser than ``test_live.py`` holds
JAX's (atol 5e-2, rtol 1e-3); incremental against one push at 1e-4.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diffsheg_tpu_torch.diffusion.sampler import NoiseSource, TableNoise  # noqa: E402
from torch_parity import (config_pair, jax_denoiser, jax_window_noise,  # noqa: E402
                          perturb, rel_rms, torch_denoiser)

C = 192
HUB = dict(hidden_size=48, num_layers=1, num_heads=2, intermediate_size=32,
           conv_dim=(8,) * 7)


def assert_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.isfinite(got).all()
    assert rel_rms(got, ref) <= 1e-4, rel_rms(got, ref)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def _audio(frames, seed, hop=1200):
    return (np.random.RandomState(seed).randn(frames * hop) * 0.1
            ).astype(np.float32)


def _audio16(frames, seed, fps=15):
    n16 = int(frames / fps * 16000)
    return (np.random.RandomState(seed).randn(n16) * 0.1).astype(np.float32)


class ChainNoise(NoiseSource):
    """The draws of a JAX session on ``key``, replayed a window at a time
    as the session asks for them: window ``w`` from the ``w``-th key of the
    chain ``rng, k = split(rng)`` (the plain program for window 0 unless
    ``stream.fix_very_first``), or (``short``) window 0 from the unsplit
    key."""

    def __init__(self, key, gen, B=1, short=False):
        self.key, self.gen, self.B, self.short = key, gen, B, short
        self._tables = {}

    def _table(self, w):
        if w not in self._tables:
            k, rng = self.key, self.key
            if not self.short:
                for _ in range(w + 1):
                    rng, k = jax.random.split(rng)
            elif w:
                raise KeyError(f"a short session draws window 0, not {w}")
            repaint = w > 0 or (self.gen.cfg.stream.fix_very_first
                                and not self.short)
            prog = self.gen._harmonize if repaint else self.gen._plain
            self._tables[w] = jax_window_noise(
                k, self.B, self.gen.cfg.data.n_poses, C, prog, repaint)
        return self._tables[w]

    def initial(self, window, shape, device):
        return TableNoise._get(self._table(window)[0], shape, device)

    def step(self, window, step, kind, shape, device):
        return TableNoise._get(self._table(window)[1][(step, kind)], shape,
                               device)


class Pair:
    """One configuration in both packages: the same weights, a JAX and a
    port window generator (shared by every session of the pair)."""

    def __init__(self, model=None, stream=None, seed=0):
        from diffsheg_tpu.sampling.generator import WindowGenerator as JG
        from diffsheg_tpu_torch.sampling.generator import WindowGenerator as PG
        self.jcfg, self.tcfg = config_pair(model=model, stream=stream)
        self.variables = jax_denoiser(self.jcfg, seed)
        self.tmodel = torch_denoiser(self.tcfg, self.variables)
        self.jgen = JG(self.jcfg, jax.tree.map(jnp.asarray, self.variables))
        self.pgen = PG(self.tcfg, self.tmodel, device="cpu")

    def pid(self, speakers=(2,)):
        j = jax.nn.one_hot(jnp.array(speakers), self.jcfg.model.style_dim)
        return j, torch.tensor(np.asarray(j))

    def noise(self, key, gen=None, short=False):
        return ChainNoise(key, gen or self.pgen, short=short)

    def sessions(self, key, jgen=None, pgen=None, short=False, jhub=None,
                 phub=None, **kw):
        from diffsheg_tpu.sampling.live import LiveSession as JL
        from diffsheg_tpu_torch.sampling.live import LiveSession as PL
        jpid, ppid = self.pid()
        pgen = pgen or self.pgen
        return (JL(jgen or self.jgen, jpid, key, hubert_extractor=jhub, **kw),
                PL(pgen, ppid, self.noise(key, gen=pgen, short=short),
                   hubert_extractor=phub, **kw))


def run(session, audio, audio16=None, chunks=1):
    outs = []
    n, n16 = len(audio), 0 if audio16 is None else len(audio16)
    for i in range(chunks):
        a = audio[i * n // chunks:(i + 1) * n // chunks]
        b = (None if audio16 is None
             else audio16[i * n16 // chunks:(i + 1) * n16 // chunks])
        outs.append(np.asarray(session.push(a, b)))
    return outs, np.asarray(session.finish())


@pytest.fixture(scope="module")
def base():
    return Pair(model=dict(add_hubert=False))


@pytest.fixture(scope="module")
def hub():
    """A HuBERT model with a tiny HuBERT (the real conv geometry) in both
    packages, the same perturbed weights."""
    from diffsheg_tpu.audio.hubert_runner import HubertFeatureExtractor as JH
    from diffsheg_tpu.models.hubert import HubertConfig as JC
    from diffsheg_tpu_torch.audio.hubert_runner import HubertFeatureExtractor as PH
    from diffsheg_tpu_torch.compat.from_jax import load_flax_tree
    from diffsheg_tpu_torch.models.hubert import HubertConfig as PC
    from diffsheg_tpu_torch.models.hubert import HubertModel
    pair = Pair(seed=5)
    jh = JH(JC(**HUB), rng=jax.random.PRNGKey(6))
    hv = perturb(jax.tree.map(np.asarray, dict(jh.variables)), 7)
    jh.variables = jax.tree.map(jnp.asarray, hv)
    pair.jhub = jh
    pair.phub = PH(model=load_flax_tree(HubertModel(PC(**HUB)), hv),
                   device="cpu")
    return pair


# -- the sessions of tests/test_live.py, JAX against the port ---------------

@pytest.mark.parametrize("T,extra", [(70, 0), (92, 0), (94, 0), (63, 1024)],
                         ids=["full-push", "small-tail", "exact-cover",
                              "not-hop-aligned"])
def test_full_push_matches_jax(base, T, extra):
    """Everything pushed at once, then finish: 70 frames (left-shifted
    final window), 92 (a final window with 2 new frames), 94 (the last
    window covers the clip exactly), 63 frames plus n_fft/2 samples (one
    mel frame past the offline plan)."""
    audio = np.concatenate([_audio(T, T), np.zeros(extra, np.float32)])
    key = jax.random.PRNGKey(T)
    js, ps = base.sessions(key)
    _, ref = run(js, audio)
    _, got = run(ps, audio)
    assert got.shape == (1, T, C)
    assert_close(got, ref)


def test_incremental_pushes(base):
    """Seven chunked pushes emit progressively; the port equals JAX push
    by push and ends within 1e-4 of one big push."""
    audio = _audio(70, 5)
    key = jax.random.PRNGKey(6)
    js, ps = base.sessions(key)
    jouts, ref = run(js, audio, chunks=7)
    pouts, got = run(ps, audio, chunks=7)
    assert sum(o.shape[1] for o in pouts) > 0
    for p, j in zip(pouts, jouts):
        assert p.shape == j.shape
        if p.shape[1]:
            assert_close(p, j)
    assert_close(got, ref)
    _, one = run(base.sessions(key)[1], audio)
    np.testing.assert_allclose(got, one, atol=1e-4, rtol=1e-4)


def test_short_session(base):
    """Less than one window: nothing emitted by push, pad-and-trim at
    finish from the session's unsplit key (noise window 0)."""
    audio = _audio(12, 8)
    key = jax.random.PRNGKey(9)
    js, ps = base.sessions(key, short=True)
    jouts, ref = run(js, audio)
    pouts, got = run(ps, audio)
    assert pouts[0].shape == (1, 0, C) and got.shape == (1, 12, C)
    assert_close(got, ref)


def test_session_matches_port_offline_host_loop(base):
    """A fully pushed session equals the port's offline host loop on the
    offline mel with the same noise."""
    from diffsheg_tpu_torch.audio.mel import MelFrontend
    from diffsheg_tpu_torch.sampling.streamer import StreamingGenerator
    T = 92
    audio = _audio(T, 11)
    key = jax.random.PRNGKey(12)
    _, ps = base.sessions(key)
    _, got = run(ps, audio)
    mel = MelFrontend(sr=18000, hop=1200, device="cpu")(audio[None])
    _, ppid = base.pid()
    offline = StreamingGenerator(base.pgen).generate(
        mel, ppid, base.noise(key)).numpy()
    assert got.shape == offline.shape == (1, T, C)
    np.testing.assert_allclose(got, offline, atol=5e-2, rtol=1e-3)


def test_window_12(base):
    """``create(window_frames=12)``: the overlap capped to 4, frames after
    13 frames of audio, the whole clip covered, equal to JAX's reduced
    session."""
    from diffsheg_tpu.sampling.live import LiveSession as JL
    from diffsheg_tpu_torch.sampling.live import LiveSession as PL
    T = 70
    audio = _audio(T, 9)
    key = jax.random.PRNGKey(10)
    jpid, ppid = base.pid()
    js = JL.create(base.jcfg, jax.tree.map(jnp.asarray, base.variables),
                   jpid, key, window_frames=12)
    ps = PL.create(base.tcfg, base.tmodel, ppid, None, window_frames=12,
                   device="cpu")
    ps.noise = base.noise(key, gen=ps.gen)
    assert (ps.size, ps.overlap, ps.step) == (js.size, js.overlap, 8) == (12, 4, 8)
    n_first = 13 * 1200
    early = ps.push(audio[:n_first])
    assert early.shape[1] > 0
    assert_close(early, js.push(audio[:n_first]))
    ps.push(audio[n_first:])
    js.push(audio[n_first:])
    got, ref = ps.finish().numpy(), np.asarray(js.finish())
    assert got.shape == (1, T, C)
    assert_close(got, ref)


def test_unbounded_mode_matches_retaining(base):
    """retain=False emits what the retaining session emits, bit for bit,
    holds ~2 windows of audio, and finish returns only the tail; both
    equal JAX.  A 16 kHz stream without a HuBERT extractor is dropped."""
    T = 170
    audio = _audio(T, 21)
    key = jax.random.PRNGKey(9)
    js, a = base.sessions(key)
    _, b = base.sessions(key, retain=False)
    outs_a, full = run(a, audio, chunks=7)
    outs_b, tail = run(b, audio, np.zeros(T * 16000 // 15, np.float32),
                       chunks=7)
    for x, y in zip(outs_a, outs_b):
        np.testing.assert_array_equal(x, y)
    assert len(b._audio16) == 0
    assert len(b._audio) <= (b.size + 2 * b.step) * b.hop + b.n_fft \
        < len(a._audio)
    np.testing.assert_array_equal(
        np.concatenate(outs_b + [tail], axis=1), full)
    assert tail.shape[1] == T - sum(o.shape[1] for o in outs_b)
    _, ref = run(js, audio, chunks=7)
    assert_close(full, ref)


def test_drain_stalled_by_span_gate(base):
    """At hop 600 (sr 9000) the analysis-span gate holds the second window
    though its frames exist; finish drains it per the offline plan."""
    data = dict(mel_sr=9000, mel_hop=600)
    # the generators do not read the mel geometry: reuse their programs
    jgen, pgen = copy.copy(base.jgen), copy.copy(base.pgen)
    jgen.cfg = base.jcfg.replace(data=dataclasses.replace(base.jcfg.data, **data))
    pgen.cfg = base.tcfg.replace(data=dataclasses.replace(base.tcfg.data, **data))
    audio = (np.random.RandomState(36).randn(64 * 600 + 100) * 0.1
             ).astype(np.float32)
    key = jax.random.PRNGKey(35)
    js, ps = base.sessions(key, jgen=jgen, pgen=pgen)
    ps.push(audio)
    assert ps._next_start == ps.step          # second window stalled
    js.push(audio)
    got, ref = ps.finish().numpy(), np.asarray(js.finish())
    assert got.shape == (1, 64, C)
    assert_close(got, ref)


def test_degenerate_geometry_raises(base):
    from diffsheg_tpu_torch.sampling.live import LiveSession as PL
    _, ppid = base.pid()
    make = lambda **kw: PL.create(base.tcfg, base.tmodel, ppid, None,  # noqa: E731
                                  device="cpu", **kw)
    with pytest.raises(ValueError, match="never advance"):
        make(window_frames=12, overlap=12)
    with pytest.raises(ValueError, match="step"):
        make(overlap=base.tcfg.data.n_poses)
    with pytest.raises(ValueError, match=">= 0"):
        make(window_frames=-3)
    s = make()
    assert (s.size, s.overlap) == (34, 4)


def test_fast_weights_built_once_per_window_length(base, monkeypatch):
    """A session's windows (and a second session on the same generator)
    build the fast path's weights once per window length; the mel
    constants are shared across sessions."""
    import diffsheg_tpu_torch.sampling.generator as G
    from diffsheg_tpu_torch.sampling.generator import WindowGenerator
    from diffsheg_tpu_torch.sampling.live import LiveSession as PL
    calls = []
    real = G.extract_fast_params
    monkeypatch.setattr(G, "extract_fast_params",
                        lambda *a, **k: calls.append(a[2]) or real(*a, **k))
    gen = WindowGenerator(base.tcfg, base.tmodel, device="cpu")
    _, ppid = base.pid()
    from diffsheg_tpu_torch.diffusion.sampler import GeneratorNoise
    a = PL(gen, ppid, GeneratorNoise(0, "cpu"))
    b = PL(gen, ppid, GeneratorNoise(1, "cpu"))
    assert a._filters is b._filters and a._window is b._window
    assert a.duration == 0.0
    out = a.push(_audio(130, 3))
    assert out.shape[1] == 4 * a.step and a._windows == 4
    b.push(_audio(70, 4))
    b.finish()
    assert calls == [34]
    assert a.duration > 0 and b._windows == 3


# -- HuBERT: window-local and left context, the 16 kHz gate ---------------

@pytest.mark.parametrize("ctx", [0.0, 2.0], ids=["window-local", "ctx-2s"])
def test_window_hubert_matches_jax(hub, ctx):
    """A window's features: window-local (padded to one chunk and masked)
    and with 2 s of left context, young (s 0, fully left-padded) and
    mid-stream (s 60)."""
    T = 102
    js, ps = hub.sessions(jax.random.PRNGKey(0), jhub=hub.jhub,
                          phub=hub.phub, hubert_ctx_s=ctx)
    for s in (js, ps):
        s._audio, s._audio16 = _audio(T, 32), _audio16(T, 33)
    for start in (0, 60):
        assert_close(ps._window_hubert(start).numpy(),
                     np.asarray(js._window_hubert(start)))


def test_hubert_session_with_context_matches_jax(hub):
    """A HuBERT session with 2 s of left context, both streams pushed in
    three chunks."""
    T = 70
    key = jax.random.PRNGKey(26)
    js, ps = hub.sessions(key, jhub=hub.jhub, phub=hub.phub,
                          hubert_ctx_s=2.0)
    a, a16 = _audio(T, 24), _audio16(T, 25)
    _, ref = run(js, a, a16, chunks=3)
    _, got = run(ps, a, a16, chunks=3)
    assert got.shape == (1, T, C)
    assert_close(got, ref)


def test_drain_stalled_by_hubert_gate(hub):
    """The whole mel stream but 16 kHz audio for the first window only:
    one window emits, more than a step of frames stalls behind the 16 kHz
    gate, and finish drains every stalled window (window-local HuBERT)."""
    T = 130
    key = jax.random.PRNGKey(31)
    js, ps = hub.sessions(key, jhub=hub.jhub, phub=hub.phub)
    a, a16 = _audio(T, 32), _audio16(T, 33)[:int(40 / 15 * 16000)]
    out = ps.push(a, a16)
    assert out.shape[1] == ps.step
    assert_close(out, js.push(a, a16))
    got, ref = ps.finish().numpy(), np.asarray(js.finish())
    assert got.shape == (1, T, C)
    assert_close(got, ref)


# -- the host-loop streamer: fix_very_first, same_overlap_noisy -------------

@pytest.mark.parametrize("stream", [
    dict(fix_very_first=True),
    dict(same_overlap_noisy=True),
    dict(fix_very_first=True, same_overlap_noisy=True)],
    ids=["fix_very_first", "same_overlap_noisy", "both"])
def test_host_loop_matches_jax(stream):
    """``StreamingGenerator.generate`` on 92 frames (windows 0, 30, a
    left-shifted 58) against JAX's; the port's ``generate_fused`` on the
    same noise within 1e-4."""
    from diffsheg_tpu.sampling.streamer import StreamingGenerator as JS
    from diffsheg_tpu_torch.sampling.streamer import StreamingGenerator as PS
    pair = Pair(model=dict(add_hubert=False), stream=stream, seed=3)
    T = 92
    mel = np.random.RandomState(4).randn(1, T, 128).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jpid, ppid = pair.pid()
    ref = np.asarray(JS(pair.jgen).generate(jnp.asarray(mel), jpid, key))
    got = PS(pair.pgen).generate(torch.tensor(mel), ppid,
                                 pair.noise(key)).numpy()
    assert_close(got, ref)
    fused = PS(pair.pgen).generate_fused(torch.tensor(mel), ppid,
                                         pair.noise(key)).numpy()
    assert_close(fused, got)


def test_get_windows_matches_jax():
    from diffsheg_tpu.sampling.streamer import get_windows as jw
    from diffsheg_tpu_torch.sampling.streamer import get_windows as pw
    for T in (20, 34, 64, 70, 94):
        x = np.arange(2 * T * 3).reshape(2, T, 3)
        a, b = pw(x, 34, 30), jw(x, 34, 30)
        assert len(a) == len(b)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
