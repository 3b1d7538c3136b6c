"""Rechunking tools: local shuffle rechunker and subject-based train/test
splitter (counterpart of ``pose3d_tpu/data/rechunk.py``; host only). The
archives hold the JAX package's members in its order, and the same seed
shuffles the same way.

Capability parity:
  * :class:`DatasetShuffler` — the reference's ``dataset_rechunker.py``:
    threaded unpack + per-sample validation of all input chunks, one global
    shuffle, threaded repack into fixed-size chunks, issues report
    (dataset_rechunker.py:145-366).
  * :class:`DatasetSplitter` — the reference's ``dataset_split.py``
    without the hard rclone dependency: chunks are read from / written to
    *transports* (local directory always; rclone remote when an
    ``rclone:`` prefix is given and the binary exists). Samples are
    validated and routed into train/test by subject id, repacked into
    ``{train|test}_dataset_chunk_{idx:06d}.tar.<comp>`` with per-chunk
    resume state (dataset_split.py:158-373).

Deliberate fix: output chunk names use six-digit indices so the streaming
loader's index filter works (the reference rechunker's 4-digit names never
match, SURVEY.md §2 quirk).

Round 3: both tools repack straight from chunk *stores* (data/chunks.py) —
archives are written member-by-member from memory, with no staging copies;
the splitter additionally STREAMS each input archive (native chunkio /
tarfile) instead of extracting it, so the 285-GB split flow costs one
sequential read per input chunk and one sequential write per output chunk
(the reference extracts everything to per-sample UUID cache dirs,
dataset_split.py:285-312). The shuffler keeps disk extraction on purpose:
a global shuffle needs random access to every source sample at repack
time, which is exactly what a disk cache is for — holding all archives in
memory instead would cost the whole dataset in RAM.
"""

from __future__ import annotations

import io
import json
import logging
import pickle
import random
import shutil
import subprocess
import tarfile
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from pose3d_tpu_torch.data.chunks import _as_store, open_chunk_store

logger = logging.getLogger("pose3d_tpu_torch.rechunk")


# -- sample validation (reference dataset_rechunker.py:89-143,
#    dataset_split.py:270-283) ---------------------------------------------

def validate_sample(sample: Dict, chunk_src,
                    require_depth: bool = False) -> Optional[str]:
    """Return None when valid, else a reason string. ``chunk_src`` is an
    extracted chunk dir or any chunk store."""
    store = _as_store(chunk_src)
    img = sample.get("image_file")
    if not img:
        return "missing image_file key"
    img_size = store.stat_member(img)
    if img_size is None:
        return f"image missing: {img}"
    if img_size == 0:
        return f"image zero bytes: {img}"
    meta = sample.get("metadata_file")
    if not meta or store.stat_member(meta) is None:
        return f"metadata missing: {meta}"
    depth = sample.get("depth_file")
    if depth:
        dsize = store.stat_member(depth)
        if dsize is None or dsize == 0:
            return f"depth missing/empty: {depth}"
    elif require_depth:
        return "no depth_file"
    return None


class SampleBlobStore:
    """A single sample's members materialized in memory — lets the
    splitter free each input archive as soon as it has been routed, so
    pending-sample memory is bounded by the samples themselves, not by
    the archives they came from."""

    def __init__(self, blobs: Dict[str, bytes]):
        self._blobs = blobs

    @classmethod
    def capture(cls, sample: Dict, store) -> "SampleBlobStore":
        blobs = {}
        for key in ("image_file", "depth_file", "metadata_file"):
            rel = sample.get(key)
            if rel:
                blob = store.read_member(rel)
                if blob is not None:
                    blobs[str(rel)] = blob
        return cls(blobs)

    def read_member(self, relpath) -> Optional[bytes]:
        return self._blobs.get(str(relpath))

    def stat_member(self, relpath) -> Optional[int]:
        blob = self._blobs.get(str(relpath))
        return None if blob is None else len(blob)


def _extract(tar_path: Path, dest: Path) -> Path:
    dest.mkdir(parents=True, exist_ok=True)
    with tarfile.open(tar_path, "r:*") as tar:
        tar.extractall(dest, filter="data")
    subdirs = [d for d in dest.iterdir() if d.is_dir()]
    if len(subdirs) == 1 and (subdirs[0] / "samples.pkl").exists():
        return subdirs[0]
    if (dest / "samples.pkl").exists():
        return dest
    for d in subdirs:
        if (d / "samples.pkl").exists():
            return d
    raise FileNotFoundError(f"samples.pkl not found under {dest}")


def _pack_chunk(samples_with_src: Sequence[Tuple[Dict, object]],
                out_path: Path, chunk_dirname: str, compression: str):
    """Write a fresh chunk archive member-by-member straight from each
    sample's source (extracted dir or in-memory store) — no staging
    copies, one sequential write. ``samples.pkl`` is written FIRST so
    streaming readers (count_chunk_samples) find it without inflating
    the whole archive (the reference's tar.add of a directory placed it
    after ``data/``)."""
    mode = f"w:{compression}" if compression != "tar" else "w"
    out_path.parent.mkdir(parents=True, exist_ok=True)

    # Pass 1 (metadata only): rewrite member paths for the new layout.
    packed = []
    blobs_to_write: List[Tuple[object, str, str]] = []  # (src, old, new)
    for j, (sample, src) in enumerate(samples_with_src):
        out = dict(sample)
        for key, default_name in (
            ("image_file", None),
            ("depth_file", "depth.png"),
            ("metadata_file", "metadata.json"),
        ):
            rel = sample.get(key)
            if not rel:
                continue
            name = default_name or f"image{Path(rel).suffix or '.jpg'}"
            new_rel = f"data/{j:06d}/{name}"
            blobs_to_write.append((src, str(rel), new_rel))
            out[key] = new_rel
        packed.append(out)

    def add_bytes(tar, name: str, data: bytes):
        info = tarfile.TarInfo(f"{chunk_dirname}/{name}")
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))

    # Pass 2: stream members into the archive (one blob in memory at a
    # time — sources are read lazily, never copied to a staging dir).
    with tarfile.open(out_path, mode) as tar:
        add_bytes(tar, "samples.pkl", pickle.dumps(packed))
        for src, old_rel, new_rel in blobs_to_write:
            blob = _as_store(src).read_member(old_rel)
            if blob is None:
                raise FileNotFoundError(
                    f"member {old_rel} vanished while packing {out_path}"
                )
            add_bytes(tar, new_rel, blob)


class DatasetShuffler:
    """Global shuffle + rechunk (reference dataset_rechunker.py:145-366)."""

    def __init__(
        self,
        input_dir,
        output_dir,
        chunk_size: int = 10000,
        compression: str = "gz",
        extracted_originals_dir=None,
        keep_extracted_originals: bool = False,
        num_workers: int = 4,
        seed: int = 42,
        name_prefix: str = "shuffled_dataset",
    ):
        self.input_dir = Path(input_dir)
        self.output_dir = Path(output_dir)
        self.chunk_size = chunk_size
        self.compression = compression
        self.keep_extracted = keep_extracted_originals
        if extracted_originals_dir:
            self.extract_dir = Path(extracted_originals_dir)
            self._own_extract_dir = False
        else:
            self.extract_dir = Path(tempfile.mkdtemp(prefix="rechunk_"))
            self._own_extract_dir = True
        self.num_workers = num_workers
        self.seed = seed
        self.name_prefix = name_prefix
        self.issues: List[str] = []

    def _load_chunk(self, tar_path: Path) -> List[Tuple[Dict, Path]]:
        dest = self.extract_dir / tar_path.name.split(".tar")[0]
        try:
            if not (dest.exists() and any(dest.rglob("samples.pkl"))):
                chunk_dir = _extract(tar_path, dest)
            else:
                chunk_dir = next(dest.rglob("samples.pkl")).parent
            with open(chunk_dir / "samples.pkl", "rb") as f:
                samples = pickle.load(f)
        except Exception as e:
            self.issues.append(f"{tar_path.name}: unreadable ({e})")
            return []
        valid = []
        for s in samples:
            reason = validate_sample(s, chunk_dir)
            if reason is None:
                valid.append((s, chunk_dir))
            else:
                self.issues.append(f"{tar_path.name}: {reason}")
        return valid

    def run(self) -> int:
        tars = sorted(self.input_dir.glob("*.tar.*"))
        logger.info("Shuffling %d input chunks", len(tars))
        all_samples: List[Tuple[Dict, Path]] = []
        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            for valid in ex.map(self._load_chunk, tars):
                all_samples.extend(valid)
        logger.info("Collected %d valid samples", len(all_samples))

        random.Random(self.seed).shuffle(all_samples)

        n_chunks = (len(all_samples) + self.chunk_size - 1) // self.chunk_size
        self.output_dir.mkdir(parents=True, exist_ok=True)

        def pack(i):
            part = all_samples[i * self.chunk_size : (i + 1) * self.chunk_size]
            name = f"{self.name_prefix}_chunk_{i:06d}.tar.{self.compression}"
            _pack_chunk(
                part, self.output_dir / name, f"chunk_{i:06d}",
                self.compression,
            )
            logger.info("Packed %s (%d samples)", name, len(part))

        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            list(ex.map(pack, range(n_chunks)))

        self._write_issues_report()
        if self._own_extract_dir and not self.keep_extracted:
            shutil.rmtree(self.extract_dir, ignore_errors=True)
        return len(all_samples)

    def _write_issues_report(self):
        if self.issues:
            report = self.output_dir / "rechunk_issues.txt"
            with open(report, "w") as f:
                f.write("\n".join(self.issues))
            logger.warning(
                "%d issues recorded in %s", len(self.issues), report
            )


class DatasetSplitter:
    """Subject-routed train/test split + rechunk
    (reference dataset_split.py:107-415), crash-resumable.

    Resume model (stronger than the reference's pending-pickle caches):
    routing is a pure function of each sample, and input chunks are
    processed in sorted order, so a crashed run can be replayed
    deterministically. The state file records, per input chunk, how many
    of its routed samples have already been written to output archives
    (``flushed``); an input chunk only graduates to ``chunks_done`` once
    ALL its routed samples are flushed. On resume, non-done chunks are
    re-streamed and their first ``flushed`` routed samples per split are
    skipped — rebuilding the exact pending lists without any staging
    copies on disk."""

    STATE_FILE = "split_state.json"

    def __init__(
        self,
        input_dir,
        output_dir,
        train_subjects: Sequence[int],
        test_subjects: Sequence[int],
        staging_dir=None,
        new_chunk_size: int = 1000,
        compression: str = "gz",
        subject_key: str = "subject",
        resume: bool = True,
    ):
        self.input_dir = Path(input_dir)
        self.output_dir = Path(output_dir)
        self.train_subjects = {int(s) for s in train_subjects}
        self.test_subjects = {int(s) for s in test_subjects}
        # Default staging lives UNDER the output dir so the crash-resume
        # state survives the process — a mkdtemp default made resume=True
        # unreachable (fresh tempdir every run, review finding).
        self.staging = (
            Path(staging_dir) if staging_dir
            else Path(output_dir) / ".split_staging"
        )
        self.staging.mkdir(parents=True, exist_ok=True)
        self.new_chunk_size = new_chunk_size
        self.compression = compression
        self.subject_key = subject_key
        self.resume = resume
        self.issues: List[str] = []

        self.state = {
            "chunks_done": [],
            "counters": {"train": 0, "test": 0},
            # per in-progress input chunk: routed samples already flushed
            # to output archives, per split (consumed on replay)
            "flushed": {},
        }
        sp = self.staging / self.STATE_FILE
        if resume and sp.exists():
            try:
                with open(sp) as f:
                    self.state.update(json.load(f))
            except Exception:
                logger.exception("Corrupt split state; starting fresh")
        # pending samples per split: (sample, blob store, input chunk name)
        self.pending: Dict[str, List[Tuple[Dict, SampleBlobStore, str]]] = {
            "train": [], "test": [],
        }
        # input chunks fully routed this run, and their not-yet-flushed
        # pending count — a chunk graduates to chunks_done at 0
        self._outstanding: Dict[str, int] = {}
        self._processed: set = set()

    def _save_state(self):
        with open(self.staging / self.STATE_FILE, "w") as f:
            json.dump(self.state, f)

    def _route(self, sample: Dict) -> Optional[str]:
        sid = sample.get(self.subject_key, sample.get("subject_id"))
        try:
            sid = int(sid)
        except (TypeError, ValueError):
            return None
        if sid in self.train_subjects:
            return "train"
        if sid in self.test_subjects:
            return "test"
        return None

    def _flush(self, split: str, final: bool = False):
        while len(self.pending[split]) >= self.new_chunk_size or (
            final and self.pending[split]
        ):
            part = self.pending[split][: self.new_chunk_size]
            self.pending[split] = self.pending[split][self.new_chunk_size:]
            idx = self.state["counters"][split]
            name = f"{split}_dataset_chunk_{idx:06d}.tar.{self.compression}"
            out = self.output_dir / split / name
            _pack_chunk(
                [(s, store) for s, store, _ in part], out,
                f"chunk_{idx:06d}", self.compression,
            )
            self.state["counters"][split] += 1
            # Crash-resume bookkeeping: these samples are now durable in
            # the output archive — credit their source chunks, and
            # graduate any fully-flushed processed chunk.
            for _, _, src_name in part:
                fl = self.state["flushed"].setdefault(
                    src_name, {"train": 0, "test": 0}
                )
                fl[split] += 1
                self._outstanding[src_name] = (
                    self._outstanding.get(src_name, 0) - 1
                )
            for src_name in {p[2] for p in part}:
                self._maybe_done(src_name)
            self._save_state()
            logger.info("Wrote %s (%d samples)", out, len(part))

    def _maybe_done(self, chunk_name: str):
        if (
            chunk_name in self._processed
            and self._outstanding.get(chunk_name, 0) <= 0
            and chunk_name not in self.state["chunks_done"]
        ):
            self.state["chunks_done"].append(chunk_name)
            self.state["flushed"].pop(chunk_name, None)

    def run(self) -> Dict[str, int]:
        tars = sorted(self.input_dir.glob("*.tar.*"))
        for tar_path in tars:
            if tar_path.name in self.state["chunks_done"]:
                continue
            # One sequential in-memory read per input archive (native
            # chunkio / tarfile streaming) — no extraction. Each routed
            # sample's members are captured into a per-sample blob store
            # so the archive is freed as soon as routing finishes:
            # pending memory is bounded by pending SAMPLES, not by the
            # archives they came from.
            try:
                store = open_chunk_store(tar_path, mode="stream")
                samples = store.samples
            except Exception as e:
                self.issues.append(f"{tar_path.name}: unreadable ({e})")
                continue
            # Deterministic replay after a crash: the first `flushed`
            # routed samples per split are already in output archives.
            skip = dict(
                self.state["flushed"].get(
                    tar_path.name, {"train": 0, "test": 0}
                )
            )
            outstanding = 0
            for s in samples:
                reason = validate_sample(s, store)
                if reason is not None:
                    self.issues.append(f"{tar_path.name}: {reason}")
                    continue
                split = self._route(s)
                if split is None:
                    self.issues.append(
                        f"{tar_path.name}: unroutable subject "
                        f"{s.get(self.subject_key)}"
                    )
                    continue
                if skip.get(split, 0) > 0:
                    skip[split] -= 1
                    continue
                self.pending[split].append(
                    (s, SampleBlobStore.capture(s, store), tar_path.name)
                )
                outstanding += 1
                # Flush full output chunks DURING routing so pending
                # memory stays bounded by new_chunk_size samples (not a
                # whole input archive's worth of captured blobs). The
                # deterministic-replay invariant holds: mid-chunk flushes
                # still consume a prefix of this chunk's routed order,
                # and _outstanding tolerates the temporary negative
                # balance until the post-loop credit.
                if len(self.pending[split]) >= self.new_chunk_size:
                    self._flush(split)
            del store
            self._outstanding[tar_path.name] = (
                self._outstanding.get(tar_path.name, 0) + outstanding
            )
            self._processed.add(tar_path.name)
            self._maybe_done(tar_path.name)
            self._save_state()
            for split in ("train", "test"):
                self._flush(split)
        for split in ("train", "test"):
            self._flush(split, final=True)
        self._write_issues_report()
        return dict(self.state["counters"])

    def _write_issues_report(self):
        if self.issues:
            report = self.staging / "split_issues.txt"
            with open(report, "w") as f:
                f.write("\n".join(self.issues))
            logger.warning(
                "%d issues recorded in %s", len(self.issues), report
            )


def rclone_available() -> bool:
    return shutil.which("rclone") is not None


def rclone_copy(src: str, dst: str, flags: Sequence[str] = ()) -> None:
    """Transfer via rclone with the reference's retry policy
    (dataset_split.py:42)."""
    subprocess.run(
        ["rclone", "copyto", src, dst, "--retries", "3",
         "--low-level-retries", "5", *flags],
        check=True,
    )
