"""pose3d_tpu_torch's data layer against the JAX package's on the same
synthetic chunks: collation, the chunk stores, ``decode_chunk_samples``
through the native decoder (the port's, built from ``native/*.cc``,
against the JAX package's) and through cv2 (each package's cv2 path),
``StreamingChunkedDataset`` + ``BatchLoader`` batches, order and ``_pos``,
the resume fast-forward, a process without the optional packages, and the
committed chunk fixture."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from helpers_synthetic import make_synthetic_chunk
import torch_port_helpers as helpers
from torch_port_helpers import (
    FIXTURE_DIR,
    FIXTURE_HW,
    write_card_fixture,
)

from pose3d_tpu.data import chunks as jchunks, collate as jcollate, \
    native as jnative, pipeline as jpipeline

from pose3d_tpu_torch.data import chunks, collate, native, pipeline

ROOT = Path(__file__).resolve().parents[1]
HW = (40, 48)


jax_on_port_library = pytest.fixture(helpers.jax_on_port_library)


@pytest.fixture(scope="module")
def chunk_dir(tmp_path_factory):
    """Three train chunks of 7 samples (three actions) and one test chunk
    of 5, 40 x 48 noise images."""
    d = tmp_path_factory.mktemp("chunks")
    for i in range(3):
        make_synthetic_chunk(d, i, num_samples=7, image_hw=HW, seed=4,
                             num_actions=3)
    make_synthetic_chunk(d, 7, num_samples=5, image_hw=HW, prefix="test",
                         seed=9, num_actions=2)
    return d


def _samples(seed, n=3, hw=(6, 5), u8=True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = hw if i else (hw[0] + 2, hw[1] - 1)
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        dep = rng.integers(0, 256, (h, w, 1), dtype=np.uint8)
        if not u8:
            img = img.astype(np.float32) / 255
            dep = dep.astype(np.float32) / 255 * 3 + 1
        out.append({"image": img, "depth": dep,
                    "keypoints_2d": rng.uniform(size=(17, 2)),
                    "joints_3d": rng.normal(size=(17, 3)),
                    "image_size": np.float32([w, h]), "depth_min": 1.0,
                    "depth_max": 4.0, "action": i, "frame_idx": i})
    return out


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("u8", [True, False])
@pytest.mark.parametrize("size", [None, (6, 5), (7, 7)])
def test_collate_fixed_matches_jax(u8, size):
    """Stacked, padded or cropped, promoted to float when off-size: the
    same arrays and lists as the JAX package's ``collate_fixed``, and the
    same ``device_batch`` / ``compact_batch`` of them."""
    batch = _samples(3, u8=u8)[1:] if size is None else _samples(3, u8=u8)
    got = collate.collate_fixed(batch, size)
    want = jcollate.collate_fixed(batch, size)
    _assert_batches_equal(got, want)
    _assert_batches_equal(collate.device_batch(got),
                          jcollate.device_batch(want))
    _assert_batches_equal(collate.compact_batch(got),
                          jcollate.compact_batch(want))
    one = _samples(4)[1]
    _assert_batches_equal(collate.sample_pixels_to_float(one),
                          jcollate.sample_pixels_to_float(one))


def test_chunk_stores_match_jax(chunk_dir, tmp_path):
    """File listing, sample counts without decoding, the three
    ``open_chunk_store`` modes and both stores' members equal the JAX
    package's; a single-sample ``decode_sample`` too."""
    files = chunks.list_chunk_files(chunk_dir, "train", [2, 0])
    assert files == jchunks.list_chunk_files(chunk_dir, "train", [2, 0])
    assert [f.name for f in files] == ["dataset_chunk_000002.tar.gz",
                                       "dataset_chunk_000000.tar.gz"]
    assert chunks.count_chunk_samples(files[0]) == 7
    for mode in ("stream", "extract", "auto"):
        got = chunks.open_chunk_store(files[0], tmp_path / "c", mode=mode)
        want = jchunks.open_chunk_store(files[0], tmp_path / "j", mode=mode)
        assert got.samples == want.samples
        for s in got.samples[:2]:
            for key in ("image_file", "depth_file", "metadata_file"):
                assert got.read_member(s[key]) == want.read_member(s[key])
    assert chunks.count_chunk_samples(files[0], tmp_path / "c") == 7
    with pytest.raises(ValueError, match="chunk_io"):
        chunks.open_chunk_store(files[0], mode="copy")
    store = chunks.open_chunk_store(files[0], mode="stream")
    got = chunks.decode_sample(store.samples[3], store, (32, 30))
    want = jchunks.decode_sample(store.samples[3], store, (32, 30))
    _assert_batches_equal({k: v for k, v in got.items() if k != "num_joints"},
                          {k: v for k, v in want.items()
                           if k != "num_joints"})


@pytest.mark.parametrize("pixel_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("route", ["native", "cv2"])
def test_decode_chunk_samples_matches_jax(chunk_dir, monkeypatch,
                                          jax_on_port_library, route,
                                          pixel_dtype):
    """The port's native path gives the JAX package's native pixels
    exactly on the library built from ``native/*.cc``, and the port's cv2
    path those of the JAX package's cv2 path (the two routes are not
    compared with each other: the native JPEG decode scales in the DCT
    domain, cv2 does not); uint8 and float32, upsampled and
    downsampled."""
    if route == "cv2":
        monkeypatch.setattr(native, "native_available", lambda: False)
        monkeypatch.setattr(jnative, "native_available", lambda: False)
    f = chunks.list_chunk_files(chunk_dir, "train", [1])[0]
    store = chunks.open_chunk_store(f, mode="stream")
    for size in ((64, 56), (20, 24)):
        got = chunks.decode_chunk_samples(store.samples, store, size,
                                          pixel_dtype=pixel_dtype)
        want = jchunks.decode_chunk_samples(store.samples, store, size,
                                            pixel_dtype=pixel_dtype)
        assert len(got) == len(want) == 7
        for g, w in zip(got, want):
            for k in ("image", "depth", "keypoints_2d", "joints_3d"):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert g["_src_index"] == w["_src_index"]


def _stream(pkg, chunk_dir, epoch=None, skip=None, n=None, **kw):
    ds = pkg.StreamingChunkedDataset(
        "train", str(chunk_dir), image_size=(32, 32), seed=5,
        pixel_dtype="uint8", cache_dir=None, **kw)
    if epoch is not None:
        ds.set_epoch(epoch)
    if skip is not None:
        ds.skip_next_samples(skip)
    loader = pkg.BatchLoader(ds, 3, loop=True)
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def _key(b):
    return (b["_pos"], b["image"].tobytes(), b["depth"].tobytes(),
            b["joints_3d"].tobytes(), tuple(b["action"]),
            b["depth_scale"].tobytes())


def test_committed_binary_differs_by_its_compiler_flags(chunk_dir,
                                                       monkeypatch):
    """The JAX package's own native path loads the committed
    ``native/libposedec.so``, built with ``-march=native``: there the
    compiler fuses the bilinear resize's multiply-adds, so a resized pixel
    that sits on a rounding edge lands one level away from the port's
    portable build. Bounded: one level, on under 0.1% of the values;
    nowhere at the stored size, where nothing is interpolated."""
    monkeypatch.delenv("POSEDEC_LIB", raising=False)
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_SEARCHED", False)
    if not Path(str(jnative._find_library())).samefile(
            ROOT / "native" / "libposedec.so"):
        pytest.skip("the JAX package finds another library here")
    f = chunks.list_chunk_files(chunk_dir, "train", [1])[0]
    store = chunks.open_chunk_store(f, mode="stream")
    for size, frac in (((64, 56), 1e-3), (HW, 0.0)):
        got = chunks.decode_chunk_samples(store.samples, store, size,
                                          pixel_dtype="uint8")
        want = jchunks.decode_chunk_samples(store.samples, store, size,
                                            pixel_dtype="uint8")
        for k in ("image", "depth"):
            a = np.stack([g[k] for g in got]).astype(int)
            b = np.stack([w[k] for w in want]).astype(int)
            assert np.abs(a - b).max() <= 1, (size, k)
            assert (a != b).mean() <= frac, (size, k)


def test_streaming_batches_match_jax(chunk_dir, jax_on_port_library):
    """Shuffled chunks and samples over three epochs of a looping loader
    (21 samples, batches of 3): the same uint8 batches in the same order
    with the same ``_pos`` as the JAX pipeline; a sharded dataset takes
    the JAX package's chunks."""
    got = _stream(pipeline, chunk_dir, n=21)
    want = _stream(jpipeline, chunk_dir, n=21)
    assert [_key(b) for b in got] == [_key(b) for b in want]
    assert got[0]["image"].dtype == np.uint8
    assert [b["_pos"] for b in got[:8]] == [(0, 3), (0, 6), (0, 9), (0, 12),
                                            (0, 15), (0, 18), (0, 21), (1, 3)]
    shard = dict(shard_id=1, num_shards=2)
    assert (pipeline.StreamingChunkedDataset("train", chunk_dir,
                                             **shard).chunk_files
            == jpipeline.StreamingChunkedDataset("train", chunk_dir,
                                                 **shard).chunk_files)


def test_resume_fast_forward_matches_jax(chunk_dir, jax_on_port_library):
    """``set_epoch`` + ``skip_next_samples`` at a recorded ``_pos``: the
    resumed stream is the uninterrupted stream's tail, in both packages
    alike (a skip inside a chunk and one past a whole chunk)."""
    full = _stream(pipeline, chunk_dir, n=16)
    for at in (3, 5):
        epoch, consumed = full[at - 1]["_pos"]
        got = _stream(pipeline, chunk_dir, epoch, consumed, n=16 - at)
        want = _stream(jpipeline, chunk_dir, epoch, consumed, n=16 - at)
        assert [_key(b) for b in got] == [_key(b) for b in full[at:]]
        assert [_key(b) for b in got] == [_key(b) for b in want]


def test_native_library_is_built_from_the_sources():
    """The decoder loads from ``build/native/libposedec-<hash>.so``, the
    hash covering ``native/posedec.cc``, ``native/chunkio.cc`` and the
    flags (no ``-march=native``); never the committed
    ``native/libposedec.so``."""
    path = native.library_path()
    assert path.parent == ROOT / "build" / "native"
    assert "-march=native" not in native.CXX_FLAGS
    assert native.native_available() and path.is_file()
    maps = Path("/proc/self/maps").read_text()
    assert str(path) in maps


def test_build_error_names_the_missing_headers(tmp_path, monkeypatch):
    src = tmp_path / "needs.cc"
    src.write_text("#include <no_such_decoder_header.h>\nint f() { return 0; }\n")
    monkeypatch.setattr(native, "SOURCES", (src,))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError,
                       match="missing headers no_such_decoder_header.h"):
        native._build(tmp_path / "out" / "lib.so")
    assert list((tmp_path / "out").iterdir()) == []


def test_decoding_without_any_decoder_raises(monkeypatch):
    """No native library and no cv2: decoding raises, naming both, and
    yields no frames."""
    monkeypatch.setattr(native, "native_available", lambda: False)
    monkeypatch.setattr(native, "build_error", lambda: "no g++ (test)")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="no g\\+\\+ \\(test\\).*cv2"):
        native.decode_jpeg_batch([b"\xff\xd8"], (4, 4))


def test_committed_fixture_decodes_as_its_pixels():
    """The committed chunk fixture: its first samples decode at their
    stored size to the committed pixels, through the native library
    exactly and through cv2 within a level; it holds a train and a test
    split of more than one action each, enough samples for a 10 x 10
    superbatch, under 1 MB in all."""
    want = np.load(FIXTURE_DIR / "pixels.npz")
    f = FIXTURE_DIR / "train" / "dataset_chunk_000000.tar.gz"
    store = chunks.open_chunk_store(f, mode="stream")
    n = len(want["image_file"])
    assert [s["image_file"] for s in store.samples[:n]] \
        == list(want["image_file"])
    for route in ("native", "cv2"):
        if route == "native":
            recs = chunks.decode_chunk_samples(store.samples[:n], store,
                                               FIXTURE_HW,
                                               pixel_dtype="uint8")
        else:
            img, _ = native._cv2_decode(
                [store.read_member(s["image_file"])
                 for s in store.samples[:n]], FIXTURE_HW, False, np.uint8)
            dep, _ = native._cv2_decode(
                [store.read_member(s["depth_file"])
                 for s in store.samples[:n]], FIXTURE_HW, True, np.uint8)
            recs = [{"image": a, "depth": b} for a, b in zip(img, dep)]
        got_img = np.stack([r["image"] for r in recs]).astype(int)
        got_dep = np.stack([r["depth"] for r in recs]).astype(int)
        np.testing.assert_array_equal(got_dep, want["depth"])
        tol = 0 if route == "native" else 1
        assert np.abs(got_img - want["image"]).max() <= tol, route
    size = sum(p.stat().st_size for p in FIXTURE_DIR.rglob("*")
               if p.is_file())
    assert size < 1 << 20
    counts = {}
    for prefix in ("train", "test"):
        samples = [s for f in chunks.list_chunk_files(FIXTURE_DIR, prefix)
                   for s in chunks.open_chunk_store(f).samples]
        counts[prefix] = len(samples)
        assert len({s["action"] for s in samples}) > 1, prefix
    assert counts["train"] >= 10 and counts["test"] >= 2


def test_fixture_writer_reproduces_the_fixture(tmp_path):
    """``torch_port_helpers.write_card_fixture`` regenerates the committed
    chunks' samples and pixels."""
    write_card_fixture(tmp_path)
    for f in chunks.list_chunk_files(FIXTURE_DIR, "train") \
            + chunks.list_chunk_files(FIXTURE_DIR, "test"):
        new = tmp_path / f.relative_to(FIXTURE_DIR)
        a, b = chunks.open_chunk_store(f), chunks.open_chunk_store(new)
        assert a.samples == b.samples
        s = a.samples[-1]
        assert a.read_member(s["image_file"]) == b.read_member(s["image_file"])
    old, new = (np.load(d / "pixels.npz") for d in (FIXTURE_DIR, tmp_path))
    for k in old.files:
        np.testing.assert_array_equal(old[k], new[k])


BLOCKED = ("cv2", "matplotlib", "PIL", "tensorboard", "tensorboardX",
           "tensorflow", "jax", "jaxlib", "flax", "pose3d_tpu")


def test_port_imports_and_decodes_without_optional_packages():
    """A fresh process in which cv2, matplotlib, PIL, TensorBoard,
    TensorFlow and JAX cannot be imported imports every module of the port
    (the inference, export and conversion CLIs, ``serve`` and
    ``stage1.api`` among them) and decodes the fixture through the native
    library, which is the one built from the sources."""
    code = textwrap.dedent(f"""
        import importlib, importlib.abc, json, pkgutil, sys
        from pathlib import Path
        BLOCKED = {BLOCKED!r}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{{name}} is blocked")
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(ROOT)!r})
        import pose3d_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            pose3d_tpu_torch.__path__, "pose3d_tpu_torch.")]
        for n in names:
            importlib.import_module(n)
        new = {{"pose3d_tpu_torch.cli.infer", "pose3d_tpu_torch.cli.export",
               "pose3d_tpu_torch.cli.convert", "pose3d_tpu_torch.serve",
               "pose3d_tpu_torch.stage1.api"}}
        assert new <= set(names), sorted(new - set(names))
        from pose3d_tpu_torch.data import chunks, native
        f = Path({str(FIXTURE_DIR)!r}) / "train" / "dataset_chunk_000000.tar.gz"
        store = chunks.open_chunk_store(f, mode="stream")
        recs = chunks.decode_chunk_samples(store.samples, store, (50, 40),
                                           pixel_dtype="uint8")
        maps = Path("/proc/self/maps").read_text()
        print(json.dumps({{
            "modules": len(names), "decoded": len(recs),
            "route": native.decode_route(),
            "built": str(native.library_path()) in maps,
            "committed": "native/libposedec.so" in maps,
            "loaded": sorted(m for m in sys.modules
                             if m.split(".")[0] in BLOCKED)}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["modules"] >= 40 and got["decoded"] == 25
    assert got["route"] == "native" and got["built"]
    assert not got["committed"] and got["loaded"] == []
