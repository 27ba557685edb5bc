"""The port's native data plane (``diffsheg_tpu_torch/runtime``) against
the JAX package's (``diffsheg_tpu.runtime``) on the same bytes and arrays:
the C++ parser and gather, the numpy paths without the library, the build
cache's staleness key, and the cache's gather through it."""

import numpy as np
import pytest

from diffsheg_tpu import runtime as jax_runtime
from diffsheg_tpu_torch import runtime

DENSE = b" ".join(b"7" for _ in range(17))
TEXTS = {
    "commas": b"1,2,3\n4,5,6\n",
    "stray-byte": b"1 2 x 3\n",
    "hex-float": b"0x1p3 1\n",
    "empty": b"",
    "dense-single-char": DENSE,
    "mixed-line-ends": b"1.0 -2.5 3e2\n4 5 6\r\n7 8 9\n",
    "blank-lines-tabs": b"\n\n1\t2\n\n3 4\n\n",
    "no-final-newline": b"1 2\n3 4",
    "signs-and-exponents": b"+1.5 -.25 1.e3 -7E-2\n.5 5. 1e-310 1e400\n",
}


def _savetxt(fmt: str, seed: int) -> bytes:
    rows = np.random.RandomState(seed).randn(20, 141) * 25
    return "\n".join(" ".join(fmt % v for v in r) for r in rows).encode() + b"\n"


@pytest.fixture
def numpy_only(monkeypatch):
    """The port's runtime as it runs without a compiler."""
    monkeypatch.setattr(runtime, "_load", lambda: None)


def test_native_builds():
    assert runtime.native_available(), "C++ dataplane failed to build"
    assert jax_runtime.native_available()
    assert runtime._library_path().parent == runtime.BUILD_DIR


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_parse_float_text_matches_jax(name):
    """Fault (a) of the port's numpy parser: commas, a stray byte and a hex
    float are read as JAX's default (native) path reads them."""
    text = TEXTS[name]
    flat, rows = runtime.parse_float_text(text)
    want, want_rows = jax_runtime.parse_float_text(text)
    assert rows == want_rows
    assert flat.dtype == np.float64
    assert flat.tobytes() == want.tobytes()


def test_fault_inputs_give_jax_arrays():
    flat, rows = runtime.parse_float_text(b"1,2,3\n4,5,6\n")
    assert rows == 2 and flat.tolist() == [1, 2, 3, 4, 5, 6]
    flat, rows = runtime.parse_float_text(b"1 2 x 3\n")
    assert rows == 1 and flat.tolist() == [1, 2, 3]
    flat, rows = runtime.parse_float_text(b"0x1p3 1\n")
    assert rows == 1 and flat.tolist() == [8, 1]


def test_parse_dense_single_char_values():
    flat, rows = runtime.parse_float_text(DENSE)
    assert len(flat) == 17 and rows == 1
    np.testing.assert_array_equal(flat, 7.0)


@pytest.mark.parametrize("fmt", ["%.6f", "%.8e", "%.17g"])
def test_parse_frames_file_matches_jax(tmp_path, fmt):
    p = tmp_path / "frames.bvh"
    p.write_bytes(_savetxt(fmt, 2))
    got = runtime.parse_frames_file(str(p))
    want = jax_runtime.parse_frames_file(str(p))
    assert got.shape == want.shape == (20, 141)
    assert got.tobytes() == want.tobytes()


def test_parse_empty_file(tmp_path):
    p = tmp_path / "empty.txt"
    p.write_text("")
    assert runtime.parse_frames_file(str(p)).size == 0
    assert jax_runtime.parse_frames_file(str(p)).size == 0


def test_ragged_rows_raise(tmp_path):
    p = tmp_path / "ragged.txt"
    p.write_text("1 2 3\n4 5\n")
    with pytest.raises(ValueError, match="do not split"):
        runtime.parse_frames_file(str(p))


@pytest.mark.parametrize("fmt", ["%.6f", "%.8e", "%.17g"])
def test_numpy_path_equals_native_on_decimal_text(numpy_only, fmt):
    text = _savetxt(fmt, 3) + b"\r\n\t1 -2\n"
    flat, rows = runtime.parse_float_text(text)
    want, want_rows = jax_runtime.parse_float_text(text)
    assert rows == want_rows
    assert flat.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", ["commas", "stray-byte", "hex-float"])
def test_numpy_path_refuses_what_native_reads_differently(numpy_only, name):
    """Without the library the parser raises, naming it, rather than
    return another array than the native parser would."""
    with pytest.raises(ValueError, match="dataplane.cpp"):
        runtime.parse_float_text(TEXTS[name])


@pytest.mark.parametrize("text", [b"1_0 2\n", b"1\x0b2\n", b"1e 2\n",
                                  b"--1\n", b"1-2\n", b"inf 1\n"])
def test_numpy_path_refuses_tokens_python_reads_otherwise(numpy_only, text):
    with pytest.raises(ValueError, match="dataplane.cpp"):
        runtime.parse_float_text(text)


def test_gather_rows_matches_jax():
    rng = np.random.RandomState(0)
    src = rng.randn(500, 7, 3).astype(np.float32)
    idx = rng.randint(0, 500, size=64)
    got = runtime.gather_rows(src, idx)
    assert got.tobytes() == jax_runtime.gather_rows(src, idx).tobytes()
    assert got.tobytes() == src[idx].tobytes()


def test_gather_rows_large_threaded(tmp_path):
    """4096 rows of a memory-mapped array over 4 threads (above the
    library's 1 MiB threading floor)."""
    path = tmp_path / "rows.npy"
    arr = np.lib.format.open_memmap(str(path), mode="w+", dtype=np.float64,
                                    shape=(4096, 300))
    arr[:] = np.arange(4096 * 300, dtype=np.float64).reshape(4096, 300)
    arr.flush()
    src = np.load(str(path), mmap_mode="r")
    idx = np.random.RandomState(1).permutation(4096)
    got = runtime.gather_rows(src, idx, n_threads=4)
    assert got.tobytes() == jax_runtime.gather_rows(src, idx,
                                                    n_threads=4).tobytes()
    assert got.tobytes() == np.take(src, idx, axis=0).tobytes()


def test_gather_rows_numpy_path_and_bounds(numpy_only):
    src = np.arange(60, dtype=np.int32).reshape(20, 3)
    idx = np.array([3, 0, 19, 3])
    assert runtime.gather_rows(src, idx).tobytes() == src[idx].tobytes()
    with pytest.raises(IndexError):
        runtime.gather_rows(src, np.array([20]))


def test_gather_rows_refuses_out_of_range_natively():
    src = np.zeros((20, 3), np.float32)
    with pytest.raises(IndexError):
        runtime.gather_rows(src, np.array([0, 20]))


def test_gather_rows_into_out():
    src = np.arange(60, dtype=np.float32).reshape(20, 3)
    idx = np.array([5, 1])
    out = np.empty((2, 3), np.float32)
    assert runtime.gather_rows(src, idx, out=out) is out
    assert out.tobytes() == src[idx].tobytes()
    for bad in (np.empty((3, 3), np.float32), np.empty((2, 3), np.float64),
                np.empty((3, 2), np.float32).T):
        with pytest.raises(ValueError, match="out must be"):
            runtime.gather_rows(src, idx, out=bad)


def test_stale_library_not_loaded(monkeypatch, tmp_path):
    """The library's name is keyed by a hash of the source and the flags:
    an edited ``dataplane.cpp`` maps to a library not built yet, so a
    library of the old source is never loaded for it."""
    src = tmp_path / "dataplane.cpp"
    src.write_text("// v1")
    monkeypatch.setattr(runtime, "_SRC", src)
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build")
    v1 = runtime._library_path()
    assert v1.parent == tmp_path / "build"
    src.write_text("// v2 — edited source")
    v2 = runtime._library_path()
    assert v1 != v2
    monkeypatch.setattr(runtime, "_FLAGS", runtime._FLAGS + ("-g",))
    assert runtime._library_path() not in (v1, v2)
    assert "-march=native" not in runtime._FLAGS


def test_cache_gather_goes_through_the_data_plane(monkeypatch, tmp_path):
    """Fault (b): ``ArrayCache.gather`` copies rows with
    ``runtime.gather_rows``, as JAX's does."""
    from diffsheg_tpu_torch.data.cache import ArrayCache, CacheWriter
    w = CacheWriter(str(tmp_path / "c"))
    rows = np.random.RandomState(4).randn(30, 5, 2).astype(np.float32)
    for r in rows:
        w.add({"x": r})
    w.finalize()
    calls = []
    real = runtime.gather_rows

    def spy(src, idx, *a, **kw):
        calls.append(len(idx))
        return real(src, idx, *a, **kw)

    monkeypatch.setattr(runtime, "gather_rows", spy)
    idx = np.array([29, 0, 7, 7])
    got = ArrayCache(str(tmp_path / "c")).gather("x", idx)
    assert calls == [4]
    assert got.tobytes() == rows[idx].tobytes()
