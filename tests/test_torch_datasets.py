"""The port's dataset readers (phovo_tpu_torch/datasets/) against
phovo_tpu's on the synthetic TUM fixture of tests/test_tum_pipeline.py:
the index files, both pairings, the cv2 reader and its prefetch byte for
byte, convert_to_raw's files byte for byte (cv2 and the libpng loader),
RawSequence's iteration and chunks, and the libpng loader against the cv2
reader (skipped, as tests/test_native_loader.py skips, where
native/libphovo_io.so cannot be built)."""

import subprocess
from pathlib import Path

import numpy as np
import pytest

from phovo_tpu.datasets import native_loader as j_native
from phovo_tpu.datasets import raw as j_raw
from phovo_tpu.datasets import tum as j_tum
from phovo_tpu_torch.datasets import native_loader as t_native
from phovo_tpu_torch.datasets import raw as t_raw
from phovo_tpu_torch.datasets import tum as t_tum

# the synthetic on-disk TUM sequence of tests/test_tum_pipeline.py
from tests.test_tum_pipeline import N_FRAMES, tum_dir  # noqa: F401

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
PAIRINGS = ["lockstep", "associate"]


@pytest.fixture(scope="module")
def native_built():
    """The libpng loader, built as tests/test_native_loader.py builds it;
    skips where it cannot be."""
    if not t_native.available():
        r = subprocess.run(["make", "-C", str(NATIVE_DIR), "libphovo_io.so"], capture_output=True, text=True)
        if r.returncode != 0:
            pytest.skip(f"cannot build native loader: {r.stderr[-500:]}")
    if not t_native.available():
        pytest.skip("native loader unavailable")


def _assert_frames_equal(a, b):
    assert (a.timestamp, a.depth_timestamp) == (b.timestamp, b.depth_timestamp)
    for x, y in ((a.intensity, b.intensity), (a.depth, b.depth)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_read_index_matches_phovo_tpu(tum_dir):  # noqa: F811
    for name in ("rgb.txt", "depth.txt"):
        assert [tuple(e) for e in t_tum.read_index(tum_dir / name)] == [
            tuple(e) for e in j_tum.read_index(tum_dir / name)]
    with pytest.raises(FileNotFoundError):
        t_tum.read_index(tum_dir / "missing.txt")


@pytest.mark.parametrize("max_dt", [0.001, 0.02, 0.1])
def test_associate_matches_phovo_tpu(tum_dir, max_dt):  # noqa: F811
    rgb, dep = t_tum.read_index(tum_dir / "rgb.txt"), t_tum.read_index(tum_dir / "depth.txt")
    got = [(tuple(a), tuple(b)) for a, b in t_tum.associate(rgb, dep, max_dt)]
    ref = [(tuple(a), tuple(b)) for a, b in j_tum.associate(
        j_tum.read_index(tum_dir / "rgb.txt"), j_tum.read_index(tum_dir / "depth.txt"), max_dt)]
    assert got == ref


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_tum_sequence_byte_equal(tum_dir, pairing):  # noqa: F811
    port = list(t_tum.TUMSequence(tum_dir, pairing=pairing))
    ref = list(j_tum.TUMSequence(tum_dir, pairing=pairing))
    assert len(port) == len(ref) == N_FRAMES
    for a, b in zip(port, ref):
        _assert_frames_equal(a, b)


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_prefetch_byte_equal(tum_dir, pairing):  # noqa: F811
    port = list(t_tum.prefetch(iter(t_tum.TUMSequence(tum_dir, pairing=pairing)), depth=2))
    ref = list(j_tum.prefetch(iter(j_tum.TUMSequence(tum_dir, pairing=pairing)), depth=2))
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        _assert_frames_equal(a, b)


def test_prefetch_raises_a_decode_error_after_the_frames_before_it(tum_dir, tmp_path):  # noqa: F811
    seq = t_tum.TUMSequence(tum_dir)
    seq.pairs = seq.pairs[:2] + [(t_tum.IndexEntry(0.0, tmp_path / "nope.png"), seq.pairs[0][1])]
    it = t_tum.prefetch(iter(seq))
    assert len([next(it), next(it)]) == 2
    with pytest.raises(IOError, match="cannot read image"):
        next(it)


def test_unknown_pairing_raises(tum_dir):  # noqa: F811
    with pytest.raises(ValueError, match="unknown pairing"):
        t_tum.TUMSequence(tum_dir, pairing="nearest")


def _convert(module, tum, out, loader, pairing, max_frames=None):
    return module.convert_to_raw(tum, out, depth_scale=t_tum.TUM_DEPTH_SCALE, pairing=pairing, loader=loader,
                                 max_frames=max_frames)


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_convert_to_raw_writes_phovo_tpus_files(tum_dir, tmp_path, pairing):  # noqa: F811
    port = _convert(t_raw, tum_dir, tmp_path / "port", "python", pairing)
    ref = _convert(j_raw, tum_dir, tmp_path / "ref", "python", pairing)
    names = sorted(p.name for p in ref.iterdir())
    assert sorted(p.name for p in port.iterdir()) == names
    for name in names:
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_convert_to_raw_with_the_libpng_loader(tum_dir, tmp_path, pairing, native_built):  # noqa: F811
    port = _convert(t_raw, tum_dir, tmp_path / "port", "native", pairing, max_frames=4)
    ref = _convert(j_raw, tum_dir, tmp_path / "ref", "native", pairing, max_frames=4)
    for name in sorted(p.name for p in ref.iterdir()):
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name
    assert len(t_raw.RawSequence(port)) == 4


@pytest.fixture
def raw_pair(tum_dir, tmp_path):  # noqa: F811
    return (t_raw.RawSequence(_convert(t_raw, tum_dir, tmp_path / "port", "python", "associate")),
            j_raw.RawSequence(_convert(j_raw, tum_dir, tmp_path / "ref", "python", "associate")))


def test_raw_sequence_iterates_as_phovo_tpus(raw_pair):
    port, ref = raw_pair
    assert t_raw.is_raw_dir(port.root) and len(port) == len(ref) == N_FRAMES
    assert (port.height, port.width, port.depth_scale, port.depth_dtype) == (
        ref.height, ref.width, ref.depth_scale, ref.depth_dtype)
    for a, b in zip(port, ref):
        _assert_frames_equal(a, b)
        assert np.asarray(a.depth).dtype == np.float32


@pytest.mark.parametrize("chunk", [1, 2, 3, N_FRAMES + 1])
def test_raw_read_chunk_matches_phovo_tpu(raw_pair, chunk):
    port, ref = raw_pair
    H, W = port.height, port.width
    seen = 0
    while True:
        (I, D, ts), (rI, rD, rts) = port.read_chunk(chunk, H, W), ref.read_chunk(chunk, H, W)
        assert I.dtype == np.uint8 and D.dtype == np.uint16
        assert I.tobytes() == rI.tobytes() and D.tobytes() == rD.tobytes() and np.array_equal(ts, rts)
        if len(I) == 0:
            break
        seen += len(I)
    assert seen == N_FRAMES


def test_raw_read_chunk_refuses_another_shape(raw_pair):
    with pytest.raises(IOError, match="expected"):
        raw_pair[0].read_chunk(2, 1, 1)


def test_raw_sequence_without_meta_raises(tmp_path):
    assert not t_raw.is_raw_dir(tmp_path)
    with pytest.raises(FileNotFoundError, match="phovo-convert"):
        t_raw.RawSequence(tmp_path)


def test_native_loader_available_as_phovo_tpus():
    assert t_native.available() == j_native.available()
    assert t_native._LIB_PATH == j_native._LIB_PATH


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_native_loader_matches_the_cv2_reader(tum_dir, pairing, native_built):  # noqa: F811
    cv2_frames = list(t_tum.TUMSequence(tum_dir, pairing=pairing))
    nat = t_native.NativeTUMSequence(tum_dir, pairing=pairing)
    frames = list(nat)
    nat.close()
    assert len(frames) == len(cv2_frames) == N_FRAMES
    for a, b in zip(cv2_frames, frames):
        assert a.timestamp == pytest.approx(b.timestamp)
        np.testing.assert_array_equal(a.intensity, b.intensity)
        np.testing.assert_allclose(a.depth, b.depth, atol=1e-6)


def test_native_loader_read_chunk_matches_the_cv2_reader(tum_dir, native_built):  # noqa: F811
    frames = list(t_tum.TUMSequence(tum_dir))
    H, W = frames[0].intensity.shape
    nat = t_native.NativeTUMSequence(tum_dir)
    I, D, ts = nat.read_chunk(3, H, W)
    for k in range(3):
        np.testing.assert_array_equal(I[k], frames[k].intensity)
        np.testing.assert_allclose(D[k], frames[k].depth, atol=1e-6)
        assert ts[k] == pytest.approx(frames[k].timestamp)
    assert len(nat.read_chunk(10, H, W)[0]) == N_FRAMES - 3
    assert len(nat.read_chunk(4, H, W)[0]) == 0
    nat.close()
