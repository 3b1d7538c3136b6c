"""Chunked-dataset container format (counterpart of
``pose3d_tpu/data/chunks.py``; numpy only, no torch).

On-disk layout, bit-compatible with the reference's chunker:

  <chunks_dir>/<prefix>/*chunk_XXXXXX.tar.{gz,bz2,xz}
    └─ chunk_XXXXXX/
        ├─ samples.pkl           # list of sample dicts
        └─ data/NNNNNN/{image.jpg, depth.png, metadata.json}

Decoding: RGB uint8 → [0, 1] float (or kept uint8) resized to the model
input size; the depth PNG rescaled to metric through the stored
depth_min/depth_max; keypoints of the first person normalised by the
original image size; joints_3d root-centred unless ``root_relative`` is
off.

OpenCV is imported inside the functions that use it (the single-sample
``decode_sample`` and the decoder's fallback), so the module imports on a
machine without it; the batched decode goes through
:mod:`pose3d_tpu_torch.data.native`.
"""

from __future__ import annotations

import json
import logging
import pickle
import re
import tarfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger("pose3d_tpu_torch.data")


def list_chunk_files(
    chunks_dir, prefix: str = "", chunk_indices: Optional[Sequence[int]] = None
) -> List[Path]:
    """Find chunk archives, optionally filtered by chunk index.

    Filters by the PARSED index rather than the reference's literal
    ``{idx:06d}.tar.`` substring match (chunked_dataset.py:447-456), so
    reference-produced 4-digit names (``human36m_chunk_0042.tar.gz``,
    written by its own dataset_rechunker.py:233) are selectable too — the
    reference's own loader silently selects zero files for those."""
    d = Path(chunks_dir) / prefix if prefix else Path(chunks_dir)
    files = sorted(d.glob("*.tar.*"))
    if chunk_indices is not None:
        by_id: Dict[int, List[Path]] = {}
        for f in files:
            m = re.search(r"chunk_(\d+)", f.name)
            if m is not None:
                by_id.setdefault(int(m.group(1)), []).append(f)
        files = [f for idx in chunk_indices for f in by_id.get(idx, [])]
    return files


def chunk_id_from_filename(path) -> int:
    """Extract the chunk id from a filename like ``human36m_chunk_000012.tar.gz``
    (reference chunked_dataset.py:314-327)."""
    m = re.search(r"chunk_(\d+)", Path(path).name)
    return int(m.group(1)) if m else 0


def count_chunk_samples(tar_path, cache_dir=None) -> int:
    """Number of samples in a chunk archive WITHOUT decoding any images.

    Used by the deterministic mid-epoch resume fast-forward: a chunk that is
    skipped entirely only needs its sample count (to keep the shuffle RNG
    stream aligned), not its pixels. Prefers the already-extracted cache
    copy of ``samples.pkl``; otherwise streams the tar until the pickle
    member is found (no extraction to disk)."""
    tar_path = Path(tar_path)
    if cache_dir is not None:
        chunk_id = chunk_id_from_filename(tar_path)
        cached = Path(cache_dir) / f"chunk_{chunk_id:06d}" / "samples.pkl"
        if cached.exists():
            with open(cached, "rb") as f:
                return len(pickle.load(f))
    with tarfile.open(tar_path, "r:*") as tar:
        for member in tar:
            if member.isfile() and Path(member.name).name == "samples.pkl":
                return len(pickle.load(tar.extractfile(member)))
    raise FileNotFoundError(f"No samples.pkl inside archive {tar_path}")


def extract_chunk(tar_path, cache_dir) -> Path:
    """Extract a chunk archive into ``cache_dir``; skip if already extracted
    (reference chunked_dataset.py:329-341). Returns the chunk directory.

    Concurrency-safe: extraction goes into a unique temp directory and the
    finished chunk dir is moved into place with one atomic rename, so a
    concurrent extractor (train_model runs two iterators over the same val
    cache) can never observe a half-written chunk. The loser of the rename
    race discards its copy."""
    import os
    import shutil
    import uuid

    tar_path = Path(tar_path)
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    chunk_id = chunk_id_from_filename(tar_path)
    chunk_dir = cache_dir / f"chunk_{chunk_id:06d}"
    if (chunk_dir / "samples.pkl").exists():
        return chunk_dir

    tmp = cache_dir / f".extract_{chunk_id:06d}_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    tmp.mkdir(parents=True)
    try:
        with tarfile.open(tar_path, "r:*") as tar:
            tar.extractall(path=tmp, filter="data")
        src = tmp / f"chunk_{chunk_id:06d}"
        if not src.exists():
            # Some chunkers use unpadded dir names; normalize.
            src = next(
                (c for c in tmp.glob("chunk_*")
                 if c.is_dir() and chunk_id_from_filename(c.name) == chunk_id),
                None,
            )
        if src is None:
            raise FileNotFoundError(
                f"No chunk_* directory inside archive {tar_path}"
            )
        try:
            os.rename(src, chunk_dir)  # atomic on POSIX
        except OSError:
            # Rename over an existing non-empty dir fails. Two cases:
            # a concurrent extractor won the race (its copy is complete
            # by definition — keep it), or a STALE partial dir without
            # samples.pkl is in the way (left by a killed run of the old
            # in-place extractor) — remove it and retry, else the cache
            # would be permanently poisoned.
            if not (chunk_dir / "samples.pkl").exists():
                shutil.rmtree(chunk_dir, ignore_errors=True)
                try:
                    os.rename(src, chunk_dir)
                except OSError:
                    if not (chunk_dir / "samples.pkl").exists():
                        raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return chunk_dir


def load_chunk_samples(chunk_dir) -> List[Dict]:
    with open(Path(chunk_dir) / "samples.pkl", "rb") as f:
        return pickle.load(f)


class DirChunkStore:
    """Chunk contents as an extracted directory (the reference's layout,
    chunked_dataset.py:329-341). ``read_member`` paths are relative to the
    chunk dir (``data/NNNNNN/image.jpg``)."""

    def __init__(self, chunk_dir):
        self.chunk_dir = Path(chunk_dir)
        self._samples: Optional[List[Dict]] = None

    @property
    def samples(self) -> List[Dict]:
        if self._samples is None:
            self._samples = load_chunk_samples(self.chunk_dir)
        return self._samples

    def read_member(self, relpath) -> Optional[bytes]:
        try:
            with open(self.chunk_dir / relpath, "rb") as f:
                return f.read()
        except OSError:
            return None

    def stat_member(self, relpath) -> Optional[int]:
        """Member size in bytes, or None when absent (cheap stat — no
        read; used by the rechunkers' validation)."""
        p = self.chunk_dir / relpath
        return p.stat().st_size if p.is_file() else None


class MemoryChunkStore:
    """Chunk contents held in memory — the archive is inflated ONCE (native
    chunkio.cc, or the Python ``tarfile`` streaming fallback) and never
    touches the disk cache. Member names keep the archive's top-level
    ``chunk_XXXXXX/`` directory; ``read_member`` takes chunk-relative paths
    like the sample dicts carry."""

    def __init__(self, members: Dict[str, bytes]):
        self._members = members
        pkl = next(
            (n for n in members
             if n == "samples.pkl" or n.endswith("/samples.pkl")),
            None,
        )
        if pkl is None:
            raise FileNotFoundError("No samples.pkl member in chunk archive")
        self._root = pkl[: -len("samples.pkl")]  # "" or "chunk_XXXXXX/"
        self.samples: List[Dict] = pickle.loads(members[pkl])

    def read_member(self, relpath) -> Optional[bytes]:
        relpath = str(relpath)
        blob = self._members.get(self._root + relpath)
        return blob if blob is not None else self._members.get(relpath)

    def stat_member(self, relpath) -> Optional[int]:
        blob = self.read_member(relpath)
        return None if blob is None else len(blob)


def _stream_chunk_members(tar_path) -> Dict[str, bytes]:
    """Python fallback for ``native.read_chunk_members``: sequential
    streaming read of the archive into memory (no extraction to disk;
    handles .tar.bz2/.xz too)."""
    members: Dict[str, bytes] = {}
    with tarfile.open(tar_path, "r|*") as tar:
        for m in tar:
            if m.isfile():
                f = tar.extractfile(m)
                if f is not None:
                    members[m.name] = f.read()
    return members


def open_chunk_store(tar_path, cache_dir=None, mode: str = "auto"):
    """Open a chunk archive as a store with ``.samples`` + ``.read_member``.

    mode:
      * ``"stream"``  — in-memory: native chunkio when built, else Python
        tarfile streaming. No disk cache is written.
      * ``"extract"`` — the reference's extract-to-cache-dir path
        (requires ``cache_dir``).
      * ``"auto"``    — reuse an already-extracted cache copy if present
        (warm epochs cost no archive read), otherwise stream; fall back to
        extraction if streaming fails.
    """
    from pose3d_tpu_torch.data import native

    tar_path = Path(tar_path)
    if mode not in ("auto", "stream", "extract"):
        raise ValueError(f"unknown chunk_io mode {mode!r}")
    if mode == "extract":
        if cache_dir is None:
            raise ValueError("chunk_io='extract' needs a cache_dir")
        return DirChunkStore(extract_chunk(tar_path, cache_dir))
    if mode == "auto" and cache_dir is not None:
        cached = (
            Path(cache_dir)
            / f"chunk_{chunk_id_from_filename(tar_path):06d}"
        )
        if (cached / "samples.pkl").exists():
            return DirChunkStore(cached)
    try:
        members = native.read_chunk_members(tar_path)
        if members is None:
            members = _stream_chunk_members(tar_path)
        return MemoryChunkStore(members)
    except Exception:
        if mode == "stream" or cache_dir is None:
            raise
        logger.exception(
            "streaming read of %s failed — falling back to extraction",
            tar_path,
        )
        return DirChunkStore(extract_chunk(tar_path, cache_dir))


def _as_store(chunk_dir_or_store):
    if hasattr(chunk_dir_or_store, "read_member"):
        return chunk_dir_or_store
    return DirChunkStore(chunk_dir_or_store)


def _first_person_keypoints(keypoints_data) -> Optional[np.ndarray]:
    """Extract the first person's (x, y) keypoints from the metadata's
    list-of-dicts (or list-of-list-of-dicts) layout
    (reference chunked_dataset.py:34-66)."""
    if (
        isinstance(keypoints_data, list)
        and keypoints_data
        and isinstance(keypoints_data[0], list)
    ):
        person = keypoints_data[0]
    elif isinstance(keypoints_data, list) and all(
        isinstance(kp, dict) for kp in keypoints_data
    ):
        person = keypoints_data
    else:
        return None
    if not person:
        return None
    return np.array(
        [[float(kp["x"]), float(kp["y"])] for kp in person], dtype=np.float32
    )


def _resize(img: np.ndarray, size_hw):
    import cv2

    h, w = size_hw
    return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)


def decode_sample_meta(sample: Dict, chunk_dir, num_joints: int = 17,
                       root_relative: bool = True,
                       fallback_image_size=None) -> Optional[Dict]:
    """Metadata-side decode: keypoints, joints, depth min/max — everything
    except the pixel data (see decode_sample steps 3-7).

    ``chunk_dir`` may be an extracted directory path or any chunk store
    (``open_chunk_store``). ``root_relative=False`` keeps absolute
    camera-space joints (DEP-P training; the reference's pipeline always
    root-centers, chunked_dataset.py:205-206 — the flag generalizes it)."""
    store = _as_store(chunk_dir)
    try:
        metadata = {}
        meta_file = sample.get("metadata_file")
        if meta_file:
            blob = store.read_member(meta_file)
            if blob is None:
                logger.error("Metadata file missing: %s", meta_file)
                return None
            metadata = json.loads(blob)

        dmin = float(sample.get("depth_min", metadata.get("depth_min", 0.0)))
        dmax = float(sample.get("depth_max", metadata.get("depth_max", 1.0)))

        kp_src = sample.get("keypoints", metadata.get("keypoints"))
        kpts = _first_person_keypoints(kp_src)
        if kpts is None or kpts.shape[0] == 0:
            logger.warning("No valid keypoints for %s", sample.get("image_file"))
            return None
        size_list = sample.get("image_size", metadata.get("image_size"))
        if size_list is None:
            size_list = fallback_image_size
        if size_list is None:
            logger.warning(
                "Sample %s has no image_size in sample dict or metadata — "
                "keypoints cannot be normalized; dropping it",
                sample.get("image_file"),
            )
            return None
        img_w, img_h = float(size_list[0]), float(size_list[1])
        kpts = kpts.copy()
        kpts[:, 0] /= img_w
        kpts[:, 1] /= img_h
        if kpts.shape[0] != num_joints:
            out = np.zeros((num_joints, 2), np.float32)
            n = min(num_joints, kpts.shape[0])
            out[:n] = kpts[:n]
            kpts = out

        joints = np.asarray(sample["joints_3d"], dtype=np.float32)
        if root_relative:
            joints = joints - joints[0:1]

        return {
            "keypoints_2d": kpts,
            "joints_3d": joints,
            "depth_min": dmin,
            "depth_max": dmax,
            "camera_params": sample.get("camera_params"),
            "image_path": sample.get("image_file"),
            "action": sample.get("action"),
            "subaction": sample.get("subaction"),
            "image_size": np.array([img_w, img_h], np.float32),
            "frame_idx": sample.get("frame_idx"),
            "num_joints": num_joints,
        }
    except Exception:
        logger.exception("Failed meta-decode for %s", sample.get("image_file"))
        return None


def decode_chunk_samples(
    samples: List[Dict],
    chunk_dir,
    image_size=(500, 500),
    num_joints: int = 17,
    num_threads: int = 8,
    root_relative: bool = True,
    pixel_dtype: str = "float32",
) -> List[Dict]:
    """Decode a whole chunk: metadata per sample (Python) + ONE native
    batched decode each for all JPEG and depth-PNG blobs (GIL-free C++;
    falls back to per-image cv2 when the native library cannot be built). This is the
    chunk-granularity replacement for the reference's 12-thread
    per-sample Python pool (reference chunked_dataset.py:247-264).

    ``chunk_dir`` may be an extracted directory path or any chunk store
    (``open_chunk_store`` — in-memory streamed archives skip the disk
    entirely).

    ``pixel_dtype="uint8"`` keeps pixels in their on-disk byte form:
    ``image`` is uint8 0..255 and ``depth`` is the raw uint8 depth PNG
    values (the stored per-sample ``depth_min``/``depth_max`` stay on the
    record; the metric rescale — u8/255·(max−min)+min, the formula of
    reference chunked_dataset.py:159-167 — runs on-device in
    train.step.decompact_batch). 4× less prefetch-queue memory and zero
    host float conversions; ``"float32"`` is the reference-shaped decode
    (floats in [0,1] / metric depth)."""
    from pose3d_tpu_torch.data import native

    if pixel_dtype not in ("float32", "uint8"):
        raise ValueError(f"unknown pixel_dtype {pixel_dtype!r}")
    u8 = pixel_dtype == "uint8"
    store = _as_store(chunk_dir)
    metas, img_blobs, dep_blobs = [], [], []
    for src_index, sample in enumerate(samples):
        meta = decode_sample_meta(sample, store, num_joints, root_relative)
        if meta is None:
            continue
        ib = store.read_member(sample["image_file"])
        db = store.read_member(sample["depth_file"])
        if ib is None or db is None:
            logger.error("Missing pixel file for %s", sample.get("image_file"))
            continue
        # Index within the INPUT list — lets the streaming pipeline
        # report raw-stream positions even when samples are dropped here
        # (deterministic mid-epoch resume counts raw samples).
        meta["_src_index"] = src_index
        metas.append(meta)
        img_blobs.append(ib)
        dep_blobs.append(db)

    if not metas:
        return []
    dt = np.uint8 if u8 else np.float32
    images, img_ok = native.decode_jpeg_batch(
        img_blobs, image_size, num_threads, dtype=dt
    )
    depths, dep_ok = native.decode_png_gray_batch(
        dep_blobs, image_size, num_threads, dtype=dt
    )

    out = []
    for meta, img, d, iok, dok in zip(
        metas, images, depths, img_ok, dep_ok
    ):
        # Per-slot decoder flags are the failure signal — an all-black
        # frame is a legal image, and a corrupt depth PNG must drop the
        # sample rather than train on depth==depth_min everywhere.
        if not iok:
            logger.error("Undecodable image %s", meta["image_path"])
            continue
        if not dok:
            logger.error("Undecodable depth for %s", meta["image_path"])
            continue
        rec = dict(meta)
        rec["image"] = img
        if u8:
            rec["depth"] = d  # raw bytes; min/max ride the record
        else:
            depth = (
                d * (meta["depth_max"] - meta["depth_min"])
                + meta["depth_min"]
            )
            rec["depth"] = depth.astype(np.float32)
        out.append(rec)
    return out


def decode_sample(
    sample: Dict,
    chunk_dir,
    image_size=(500, 500),
    num_joints: int = 17,
    root_relative: bool = True,
) -> Optional[Dict]:
    """Decode one sample dict into fixed-shape numpy arrays (NHWC).

    Pixels decode via cv2 (single-sample path); everything else delegates
    to :func:`decode_sample_meta` so the two decode paths cannot drift.
    The decoded image's original dimensions
    serve as the image_size fallback when the metadata lacks it.

    Returns None on any failure (per-sample skip-on-error, reference
    chunked_dataset.py:234-244).
    """
    import cv2

    store = _as_store(chunk_dir)
    try:
        # 1/2. RGB + depth images.
        img_blob = store.read_member(sample["image_file"])
        if img_blob is None:
            logger.error("RGB image missing: %s", sample.get("image_file"))
            return None
        img_bgr = cv2.imdecode(
            np.frombuffer(img_blob, np.uint8), cv2.IMREAD_COLOR
        )
        if img_bgr is None:
            logger.error("Undecodable RGB image: %s", sample["image_file"])
            return None
        orig_h, orig_w = img_bgr.shape[:2]
        img = cv2.cvtColor(img_bgr, cv2.COLOR_BGR2RGB)
        img = _resize(img, image_size).astype(np.float32) / 255.0  # [H,W,3]

        dep_blob = store.read_member(sample["depth_file"])
        if dep_blob is None:
            logger.error("Depth image missing: %s", sample.get("depth_file"))
            return None
        depth_raw = cv2.imdecode(
            np.frombuffer(dep_blob, np.uint8), cv2.IMREAD_GRAYSCALE
        )
        if depth_raw is None:
            logger.error("Undecodable depth image: %s", sample["depth_file"])
            return None
        depth01 = _resize(depth_raw, image_size).astype(np.float32) / 255.0

        # 3-7. Metadata / keypoints / joints (shared with the batch path).
        meta = decode_sample_meta(
            sample, store, num_joints, root_relative,
            fallback_image_size=[float(orig_w), float(orig_h)],
        )
        if meta is None:
            return None

        # 4. Depth rescale toward metric using stored min/max
        #    (reference chunked_dataset.py:159-167).
        depth = (
            depth01 * (meta["depth_max"] - meta["depth_min"])
            + meta["depth_min"]
        )[..., None]  # [H,W,1]

        rec = dict(meta)
        rec["image"] = img
        rec["depth"] = depth.astype(np.float32)
        return rec
    except Exception:
        logger.exception("Failed to decode sample %s", sample.get("image_file"))
        return None
