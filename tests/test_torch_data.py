"""The port's own copies of the data layer and the metrics
(``diffsheg_tpu_torch/data/{cache,loader,beat,show}.py``,
``eval/metrics.py``, ``utils/logging.py``) against the JAX package's:
caches written by either read in the other, dataset batches and the
loader's epoch order equal, metrics within 1e-12."""

import json
import threading
import time

import numpy as np
import pytest

from diffsheg_tpu.data import beat as jbeat
from diffsheg_tpu.data import cache as jcache
from diffsheg_tpu.data import loader as jloader
from diffsheg_tpu.data import show as jshow
from diffsheg_tpu.eval import metrics as jmetrics
from diffsheg_tpu.utils.logging import MetricLogger as JLogger
from diffsheg_tpu_torch.data import beat as tbeat
from diffsheg_tpu_torch.data import cache as tcache
from diffsheg_tpu_torch.data import loader as tloader
from diffsheg_tpu_torch.data import show as tshow
from diffsheg_tpu_torch.eval import metrics as tmetrics
from diffsheg_tpu_torch.utils.logging import MetricLogger as TLogger

T = 8


def beat_rows(n, seed, T=T):
    rs = np.random.RandomState(seed)
    return [{"pose": rs.randn(T, 141).astype(np.float32),
             "pose_axis_angle": rs.randn(T, 141).astype(np.float32),
             "audio": rs.randn(T * 1067).astype(np.float32),
             "mel": rs.randn(T, 128).astype(np.float32),
             "facial": rs.randn(T, 51).astype(np.float32),
             "sem": rs.rand(T).astype(np.float32),
             "id": np.asarray([rs.randint(30)], np.int32),
             "word": rs.randint(-1, 50, T).astype(np.int32),
             "emo": rs.randint(0, 8, T).astype(np.int32)}
            for _ in range(n)]


def write(writer_cls, path, rows, meta=None):
    w = writer_cls(str(path), meta=meta)
    for r in rows:
        w.add(r)
    w.finalize()
    return str(path)


def assert_same_dict(a, b):
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_caches_read_across_packages(tmp_path, writer):
    """Fixed and ragged fields and the manifest's meta, written by one
    package and read by the other."""
    rs = np.random.RandomState(0)
    rows = [{"x": rs.randn(3, 2).astype(np.float32),
             "clip": rs.randn(rs.randint(2, 7), 4).astype(np.float32),
             "id": np.asarray([i], np.int64)} for i in range(5)]
    w_cls, r_cls = ((jcache.CacheWriter, tcache.ArrayCache)
                    if writer == "jax" else
                    (tcache.CacheWriter, jcache.ArrayCache))
    path = write(w_cls, tmp_path / "c", rows, meta={"n_poses": 3})
    other = (jcache if writer == "port" else tcache).ArrayCache(path)
    read = r_cls(path)
    assert read.meta == {"n_poses": 3} and len(read) == 5
    assert tcache.cache_exists(path) and jcache.cache_exists(path)
    for i in range(5):
        assert_same_dict(read[i], rows[i])
    idx = np.array([4, 0, 2])
    assert_same_dict(read.batch(idx), other.batch(idx))
    with pytest.raises(Exception):
        read.gather("clip", idx)


@pytest.mark.parametrize("remove_hand", [False, True])
def test_beat_dataset_batches_match_jax(tmp_path, remove_hand):
    rows = beat_rows(12, 1)
    path = write(jcache.CacheWriter, tmp_path / "beat", rows,
                 meta={"n_poses": T})
    jds = jbeat.BeatDataset(path, remove_hand=remove_hand)
    tds = tbeat.BeatDataset(path, remove_hand=remove_hand)
    assert len(tds) == 12 and tds.n_poses == jds.n_poses == T
    idx = np.array([3, 7, 0, 11])
    assert_same_dict(tds.batch(idx), jds.batch(idx))
    assert_same_dict(tds[5], jds[5])


@pytest.mark.parametrize("frames", [T, T + 5])
def test_beat_dataset_hubert_cache(tmp_path, frames):
    """A HuBERT cache (field ``hubert``, each window's features) is
    resampled to the window's frames as the JAX ``_interp_frames`` does.
    The JAX dataset itself hands ``_interp_frames`` the cache's sample
    dict and fails there, so the reference is its function on the
    field."""
    rs = np.random.RandomState(2)
    path = write(jcache.CacheWriter, tmp_path / "beat", beat_rows(6, 3))
    feats = [rs.randn(frames, 16).astype(np.float32) for _ in range(6)]
    hub = write(jcache.CacheWriter, tmp_path / "hub",
                [{"hubert": f} for f in feats])
    tds = tbeat.BeatDataset(path, hubert_cache_dir=hub)
    idx = np.array([5, 1, 2])
    want = np.stack([jbeat._interp_frames(feats[i], T) for i in idx])
    got = tds.batch(idx)["hubert"]
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(tds[4]["hubert"],
                                  jbeat._interp_frames(feats[4], T))
    with pytest.raises(AttributeError):
        jbeat.BeatDataset(path, hubert_cache_dir=hub).batch(idx)


def show_fixture(tmp_path, n=6):
    rs = np.random.RandomState(4)
    rows = [{"pose": rs.randn(T, 165).astype(np.float32),
             "expression": rs.randn(T, 100).astype(np.float32),
             "mel": rs.randn(T, 128).astype(np.float32),
             "audio": rs.randn(T * 533).astype(np.float32),
             "speaker": np.eye(4, dtype=np.float32)[i % 4]}
            for i in range(n)]
    path = write(jcache.CacheWriter, tmp_path / "show", rows)
    stats = {"pose_mean": rs.randn(165), "pose_std": 1 + rs.rand(165),
             "expression_mean": rs.randn(100),
             "expression_std": 1 + rs.rand(100)}
    spath = str(tmp_path / "talkshow_mean_std.npy")
    np.save(spath, stats, allow_pickle=True)
    return path, spath


@pytest.mark.parametrize("audio_feat,remove_hand",
                         [("mel", False), ("raw", False), ("mel", True)])
def test_show_dataset_batches_match_jax(tmp_path, audio_feat, remove_hand):
    path, spath = show_fixture(tmp_path)
    kw = dict(remove_hand=remove_hand, audio_feat=audio_feat)
    jds = jshow.ShowDataset(path, jshow.ShowStats.load(spath), **kw)
    tds = tshow.ShowDataset(path, tshow.ShowStats.load(spath), **kw)
    idx = np.array([2, 0, 5])
    assert_same_dict(tds.batch(idx), jds.batch(idx))
    np.testing.assert_array_equal(
        tshow.combine_expression(np.ones((2, 165)), np.zeros((2, 100))),
        jshow.combine_expression(np.ones((2, 165)), np.zeros((2, 100))))


@pytest.mark.parametrize("field", [True, False])
def test_show_dataset_mfcc_matches_jax(tmp_path, field):
    # audio_feat='mfcc': the cache's mfcc field, or on a cache without it
    # the MFCC of the window's audio (within 2e-5 of scale)
    from torch_parity import mel_close
    path, spath = show_fixture(tmp_path)
    if field:
        rows = [dict(tcache.ArrayCache(path)[i]) for i in range(6)]
        rs = np.random.RandomState(9)
        for r in rows:
            r["mfcc"] = rs.randn(T, 64).astype(np.float32)
        path = write(tcache.CacheWriter, tmp_path / "mfcc", rows)
    jds = jshow.ShowDataset(path, jshow.ShowStats.load(spath),
                            audio_feat="mfcc")
    tds = tshow.ShowDataset(path, tshow.ShowStats.load(spath),
                            audio_feat="mfcc", device="cpu")
    for i in (0, 4):
        got, want = tds[i], jds[i]
        assert sorted(got) == sorted(want) and got["mel"].shape == (T, 64)
        for k in want:
            if k == "mel" and not field:
                mel_close(got[k], want[k])
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


class _Rows:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def batch(self, idx):
        return {"i": np.asarray(idx)}


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("drop_last,shuffle", [(True, True), (False, True),
                                               (True, False)])
@pytest.mark.parametrize("count", [1, 2, 4])
def test_loader_epoch_order_matches_jax(seed, drop_last, shuffle, count):
    for epoch in range(3):
        for index in range(count):
            kw = dict(global_batch_size=8, seed=seed, shuffle=shuffle,
                      drop_last=drop_last, process_index=index,
                      process_count=count, prefetch=0)
            a, b = tloader.ShardedBatchLoader(_Rows(21), **kw), \
                jloader.ShardedBatchLoader(_Rows(21), **kw)
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            assert len(a) == len(b)
            got = [x["i"] for x in a]
            assert got and all(
                np.array_equal(x, y["i"]) for x, y in zip(got, b))
            # the prefetch thread yields the same batches
            a.prefetch = 2
            assert all(np.array_equal(x["i"], y)
                       for x, y in zip(a, got))
    with pytest.raises(ValueError):
        tloader.ShardedBatchLoader(_Rows(8), 6, process_count=4)


def test_loader_end_mark_waits_for_room():
    """With the queue full when the last batch is in, the end mark still
    arrives (the JAX loader drops it then, and its consumer waits
    forever); an abandoned iteration releases the worker."""
    loader = tloader.ShardedBatchLoader(_Rows(4), 2, prefetch=1)
    got = []

    def consume():
        for b in loader:
            got.append(b)
            time.sleep(0.3)

    th = threading.Thread(target=consume, daemon=True)
    th.start()
    th.join(timeout=20)
    assert not th.is_alive() and len(got) == 2
    before = set(threading.enumerate())
    it = iter(tloader.ShardedBatchLoader(_Rows(64), 2, prefetch=1))
    next(it)
    it.close()
    workers = set(threading.enumerate()) - before
    for w in workers:
        w.join(timeout=10)
    assert not any(w.is_alive() for w in workers)


@pytest.mark.parametrize("C", [192, 232])
def test_metrics_match_jax(C):
    rs = np.random.RandomState(C)
    out, tgt = rs.randn(3, 5, C), rs.randn(3, 5, C)
    for thr in (0.5, 2.0):
        assert tmetrics.mse_pck_channels(out, tgt, thr) == \
            jmetrics.mse_pck_channels(out, tgt, thr)
    for n in (7, 120):
        x = rs.randn(n, 4, C).astype(np.float32)
        assert tmetrics.diversity(x, 50) == pytest.approx(
            jmetrics.diversity(x, 50), rel=1e-12)
    a, b = rs.randn(40, 6), rs.randn(50, 6) + 0.3
    assert tmetrics.frechet_from_activations(a, b) == pytest.approx(
        jmetrics.frechet_from_activations(a, b), rel=1e-12)


def test_metric_logger_records_like_jax(tmp_path):
    records = []
    for cls, d in ((JLogger, tmp_path / "j"), (TLogger, tmp_path / "t")):
        log = cls(str(d), name="run")
        log.log_metrics(3, {"loss": 1.5, "epoch": 2})
        log.log_text("hello")
        log.close()
        with open(d / "metrics.jsonl") as f:
            recs = [json.loads(x) for x in f]
        for r in recs:
            r.pop("t")
        records.append(recs)
    assert records[0] == records[1] == [
        {"step": 3, "loss": 1.5, "epoch": 2.0}, {"text": "hello"}]
