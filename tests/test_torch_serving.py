"""The port's serving daemon (``serving/server.py``), on the CPU.

The cases of ``tests/test_serving.py``: a served live session equals the
in-process ``LiveSession`` exactly; bad clients are refused with an error
frame; sessions, streams, backlogs, idle clients and the geometry cache
are bounded; prewarm builds the shared generator.  Every socket carries a
timeout and every server is shut down in a ``finally`` or fixture
teardown, so no test can hang the suite.
"""

import dataclasses
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diffsheg_tpu_torch.config import beat_config  # noqa: E402
from diffsheg_tpu_torch.diffusion.sampler import GeneratorNoise  # noqa: E402
from diffsheg_tpu_torch.models.unidiffuser import init_unidiffuser  # noqa: E402
from diffsheg_tpu_torch.sampling.live import LiveSession  # noqa: E402
from diffsheg_tpu_torch.serving import protocol as proto  # noqa: E402
from diffsheg_tpu_torch.serving.server import MotionClient, MotionServer  # noqa: E402

TIMEOUT = 60.0
# tiny shapes: intra-op threads gain nothing, and with several pytest
# workers they contend (tests/torch_parity.py sets the same)
torch.set_num_threads(1)


def _setup(add_hubert=False):
    cfg = beat_config()
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, latent_dim=32, num_layers=1, num_heads=2, ff_size=64,
        add_hubert=add_hubert, hubert_dim=32, hubert_latent_dim=16))
    return cfg, init_unidiffuser(cfg.model, seed=0)


def _audio(cfg, frames, seed=1):
    n = frames * cfg.data.mel_hop
    return (np.random.RandomState(seed).randn(n) * 0.1).astype(np.float32)


def _server(cfg, model, **kw):
    srv = MotionServer(cfg, model, log=lambda *a: None, device="cpu", **kw)
    srv.start_background()
    return srv


def _open_session(host, port, retries=100):
    """A raw socket with a started session; retries while the
    max_sessions=1 slot is still being released by an earlier handler."""
    for _ in range(retries):
        sock = socket.create_connection((host, port), timeout=TIMEOUT)
        proto.send_frame(sock, {"type": "start", "speakers": [1]})
        header, _ = proto.recv_frame(sock)
        if header["type"] == "ready":
            return sock
        sock.close()
        time.sleep(0.05)
    raise AssertionError("never obtained a session slot")


def _client(host, port, retries=100, **start_kw):
    """A MotionClient with a started session (same retry rationale)."""
    for _ in range(retries):
        cli = MotionClient(host, port, timeout=TIMEOUT)
        try:
            cli.start(**start_kw)
            return cli
        except RuntimeError as e:
            cli.close()
            if "max_sessions" not in str(e):
                raise
            time.sleep(0.05)
    raise AssertionError("never obtained a session slot")


def _oracle(cfg, model, speakers, seed, audio, **kw):
    pid = torch.nn.functional.one_hot(torch.tensor(speakers),
                                      cfg.model.style_dim).float()
    s = LiveSession.create(cfg, model, pid, GeneratorNoise(seed, "cpu"),
                           device="cpu", **kw)
    s.push(audio)
    return s.finish().numpy()


@pytest.fixture(scope="module")
def server():
    cfg, model = _setup()
    srv = _server(cfg, model, max_sessions=1, client_geometry=True)
    yield cfg, model, srv.address
    srv.shutdown()


class TestServing:
    def test_served_session_matches_in_process(self, server):
        cfg, model, (host, port) = server
        T = 70
        audio = _audio(cfg, T)
        want = _oracle(cfg, model, [2], 7, audio)
        with _client(host, port, speakers=[2], seed=7) as cli:
            assert cli.info["channels"] == cfg.model.motion_dim
            assert cli.info["window"] == cfg.data.n_poses
            parts, chunk = [], len(audio) // 5
            for i in range(5):
                parts.append(cli.push(audio[i * chunk:(i + 1) * chunk]))
            parts.append(cli.push(audio[5 * chunk:]))
            full = cli.finish()
        assert sum(p.shape[1] for p in parts) > 0      # streamed early
        assert full.shape == want.shape == (1, T, cfg.model.motion_dim)
        np.testing.assert_array_equal(full, want)
        inc = np.concatenate(parts, axis=1)
        np.testing.assert_array_equal(inc, full[:, :inc.shape[1]])

    def test_reduced_window_session(self, server):
        cfg, _, (host, port) = server
        with _client(host, port, speakers=[0, 3], seed=1,
                     window_frames=12) as cli:
            assert cli.info["window"] == 12 and cli.info["batch"] == 2
            cli.push(_audio(cfg, 40, seed=9))
            full = cli.finish()
        assert full.shape == (2, 40, cfg.model.motion_dim)
        assert np.isfinite(full).all()

    @pytest.mark.parametrize("start,match", [
        (dict(speakers=[35]), "speakers must be"),
        (dict(speakers=[True]), "speakers must be"),
        (dict(speakers=[0] * 65), "max_batch"),
        (dict(speakers=[0], window_frames=12, overlap=12),
         "never advance|step"),
        (dict(speakers=[0], window_frames=10 ** 9), "must be ints")],
        ids=["bad-speaker", "bool-speaker", "oversized-batch",
             "degenerate-geometry", "huge-window"])
    def test_bad_start_rejected(self, server, start, match):
        _, _, (host, port) = server
        with pytest.raises(RuntimeError, match=match):
            _client(host, port, **start)

    def test_unknown_message_type_errors(self, server):
        _, _, (host, port) = server
        sock = _open_session(host, port)
        try:
            proto.send_frame(sock, {"type": "frobnicate"})
            header, _ = proto.recv_frame(sock)
            assert header["type"] == "error"
            assert "frobnicate" in header["message"]
        finally:
            sock.close()

    def test_max_sessions_bound_and_slot_release(self, server):
        cfg, _, (host, port) = server
        first = _open_session(host, port)
        try:
            second = socket.create_connection((host, port), timeout=TIMEOUT)
            try:
                header, _ = proto.recv_frame(second)
                assert header["type"] == "error"
                assert "max_sessions" in header["message"]
            finally:
                second.close()
        finally:
            first.close()
        with _client(host, port, speakers=[1], seed=0) as cli:
            cli.push(_audio(cfg, 10, seed=3))
            cli.finish()
        with _client(host, port, speakers=[0], seed=0) as cli:
            assert cli.info["batch"] == 1


class TestHardening:
    def test_client_geometry_refused_by_default(self):
        cfg, model = _setup()
        srv = _server(cfg, model, max_sessions=1)
        try:
            host, port = srv.address
            with pytest.raises(RuntimeError, match="default window"):
                _client(host, port, speakers=[0], window_frames=12)
            with _client(host, port, speakers=[0], seed=0) as cli:
                assert cli.info["window"] == cfg.data.n_poses
        finally:
            srv.shutdown()

    def test_idle_session_reaped(self):
        cfg, model = _setup()
        srv = _server(cfg, model, max_sessions=1, idle_timeout=0.3)
        try:
            host, port = srv.address
            silent = _open_session(host, port)
            try:
                header, _ = proto.recv_frame(silent)   # the server reaps us
                assert header["type"] == "error"
                assert "idle" in header["message"]
            finally:
                silent.close()
            with _client(host, port, speakers=[0], seed=0) as cli:
                assert cli.info["batch"] == 1
        finally:
            srv.shutdown()

    def test_stream_length_capped(self):
        cfg, model = _setup()
        srv = _server(cfg, model, max_sessions=1, max_stream_seconds=0.5)
        try:
            with _client(*srv.address, speakers=[0]) as cli:
                with pytest.raises(RuntimeError, match="max_stream_seconds"):
                    cli.push(np.zeros(cfg.data.mel_sr, np.float32))
        finally:
            srv.shutdown()

    def test_unbounded_session_waives_stream_cap(self):
        """retain=False: no stream cap, each frame streamed once, "done"
        carries the tail; the whole equals the in-process session."""
        cfg, model = _setup()
        srv = _server(cfg, model, max_sessions=1, max_stream_seconds=2.0)
        try:
            T = 70
            audio = _audio(cfg, T, seed=11)        # ~4.7 s > the cap
            want = _oracle(cfg, model, [2], 5, audio)
            with _client(*srv.address, speakers=[2], seed=5,
                         retain=False) as cli:
                parts = [cli.push(audio[i * len(audio) // 4:
                                        (i + 1) * len(audio) // 4])
                         for i in range(4)]
                tail = cli.finish()
            np.testing.assert_array_equal(
                np.concatenate(parts + [tail], axis=1), want)
            assert tail.shape[1] == T - sum(p.shape[1] for p in parts) < T
        finally:
            srv.shutdown()

    def test_stalled_unbounded_session_backlog_capped(self):
        """Mel pushed without its 16 kHz stream stalls a HuBERT session;
        the backlog is bounded."""
        from diffsheg_tpu_torch.audio.hubert_runner import HubertFeatureExtractor
        from diffsheg_tpu_torch.models.hubert import HubertConfig
        cfg, model = _setup(add_hubert=True)
        hub = HubertFeatureExtractor(HubertConfig(
            hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
            conv_dim=(16,) * 7), device="cpu")
        srv = _server(cfg, model, hubert_extractor=hub, max_sessions=1,
                      max_stream_seconds=3.0)
        try:
            with _client(*srv.address, speakers=[0], retain=False) as cli:
                with pytest.raises(RuntimeError, match="backlog"):
                    for _ in range(12):
                        cli.push(np.zeros(cfg.data.mel_sr, np.float32))
        finally:
            srv.shutdown(drain_seconds=0.1)

    def test_shutdown_waits_for_active_sessions(self):
        cfg, model = _setup()
        srv = _server(cfg, model, max_sessions=1)
        sock = _open_session(*srv.address)
        try:
            t0 = time.monotonic()
            srv.shutdown(drain_seconds=0.4)        # a session is held open
            assert 0.35 <= time.monotonic() - t0 < 5.0
        finally:
            sock.close()
        srv2 = _server(cfg, model, max_sessions=1)
        t0 = time.monotonic()
        srv2.shutdown(drain_seconds=2.0)           # none: no grace period
        assert time.monotonic() - t0 < 1.0

    def test_prewarm_and_shared_generators(self):
        """prewarm builds the generator (and its fast-path weights) that a
        client at that batch size then reuses; a new geometry adds one."""
        cfg, model = _setup()
        srv = _server(cfg, model, max_sessions=1, client_geometry=True)
        try:
            srv.prewarm((2,))
            assert len(srv._gens) == 1
            first = next(iter(srv._gens.values()))
            assert set(first._fast) == {cfg.data.n_poses}
            host, port = srv.address
            with _client(host, port, speakers=[1, 3], seed=2) as cli:
                cli.push(_audio(cfg, 40, seed=4))
                full = cli.finish()
            assert full.shape[0] == 2 and np.isfinite(full).all()
            for _ in range(2):
                with _client(host, port, speakers=[1], seed=0) as cli:
                    cli.finish()                   # empty session is fine
            assert list(srv._gens.values()) == [first]
            with _client(host, port, speakers=[2], seed=5,
                         window_frames=12) as cli:
                cli.finish()
            assert len(srv._gens) == 2
            assert next(iter(srv._gens.values())) is first
        finally:
            srv.shutdown()

    def test_geometry_cache_bounded(self):
        cfg, model = _setup()
        srv = _server(cfg, model, max_sessions=1, client_geometry=True,
                      max_cached_geometries=2)
        try:
            srv.prewarm((1,))
            pinned = next(iter(srv._gens))
            for wf in (10, 12, 14):
                with _client(*srv.address, speakers=[0],
                             window_frames=wf) as cli:
                    cli.finish()
            assert len(srv._gens) <= 3             # cap + the one just used
            assert pinned in srv._gens
        finally:
            srv.shutdown()

    def test_handler_thread_runs_without_autograd(self):
        """Grad mode is per thread: a session served from a handler thread
        builds no autograd graph even though the model's parameters
        require grad."""
        cfg, model = _setup()
        assert next(model.parameters()).requires_grad
        srv = _server(cfg, model, max_sessions=1)
        seen = []
        real = LiveSession._run_window

        def spy(self, *a):
            out = real(self, *a)
            seen.append((torch.is_grad_enabled(), out.requires_grad))
            return out

        try:
            LiveSession._run_window = spy
            with _client(*srv.address, speakers=[0]) as cli:
                cli.push(_audio(cfg, 40, seed=2))
        finally:
            LiveSession._run_window = real
            srv.shutdown()
        assert seen and all(s == (False, False) for s in seen)


class TestProtocol:
    def test_motion_roundtrip(self):
        m = np.random.RandomState(0).randn(2, 5, 7).astype(np.float32)
        h, p = proto.pack_motion(m)
        np.testing.assert_array_equal(proto.unpack_motion(h, p), m)

    def test_audio_roundtrip(self):
        a = np.random.RandomState(1).randn(100).astype(np.float32)
        b = np.random.RandomState(2).randn(89).astype(np.float32)
        ga, gb = proto.unpack_audio(*proto.pack_audio(a, b))
        np.testing.assert_array_equal(ga, a)
        np.testing.assert_array_equal(gb, b)
        ga, gb = proto.unpack_audio(*proto.pack_audio(a))
        np.testing.assert_array_equal(ga, a)
        assert gb is None

    def test_corrupt_payload_rejected(self):
        with pytest.raises(proto.ProtocolError):
            proto.unpack_motion({"batch": 1, "frames": 3, "channels": 2},
                                b"\x00" * 7)
        with pytest.raises(proto.ProtocolError):
            proto.unpack_audio({"n": 10, "n16": 0}, b"\x00" * 8)
        with pytest.raises(proto.ProtocolError):
            proto.pack_motion(np.zeros((3, 4), np.float32))
