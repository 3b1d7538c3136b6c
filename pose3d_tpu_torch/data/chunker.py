"""Human3.6M dataset assembly: annotations + preprocess artifacts → tar chunks
(counterpart of ``pose3d_tpu/data/chunker.py``; host only: json, numpy,
tarfile). The archives hold the JAX package's members, in its order, with
its bytes, so either package reads the other's.

Capability parity with the reference's ``dataset_chunker.py`` (972 LoC):

  * loads the three per-subject annotation JSONs (data / camera / joint_3d,
    reference dataset_chunker.py:407-419);
  * joins images with preprocessed depth/metadata artifacts by existence
    (reference :441-448);
  * transforms GT joints world→camera per the sample's camera
    (reference :579);
  * packs ``chunk_XXXXXX/{samples.pkl, data/NNNNNN/{image,depth,metadata}}``
    into ``human36m_chunk_XXXXXX.tar.<comp>`` (reference :731-753);
  * resumable state machine ``chunker_state.json`` tracking processed
    files, created and uploaded chunks (reference :141-267);
  * SIGINT/SIGTERM graceful pause: finish the current unit, save state,
    exit 0 (reference :274-301);
  * throttled copy "upload" to the output directory (reference :775-827).

Deliberate fix: chunk filenames use SIX-digit indices
(``human36m_chunk_000042.tar.gz``) — the reference writes 4-digit names
that its own loader's ``{idx:06d}`` index filter can never match
(SURVEY.md §2 quirk; reference dataset_chunker.py:661 vs
chunked_dataset.py:453).
"""

from __future__ import annotations

import io
import json
import logging
import pickle
import shutil
import signal
import tarfile
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger("pose3d_tpu_torch.chunker")


def world_to_camera_np(joints_world, R, t) -> np.ndarray:
    """Host-side world→camera transform (numpy, fp64; the math of
    ``geometry.camera.world_to_camera``)."""
    R = np.asarray(R, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64).reshape(3)
    jw = np.asarray(joints_world, dtype=np.float64)
    return jw @ R.T + t


class Human36MChunker:
    STATE_FILE = "chunker_state.json"

    def __init__(
        self,
        subject_ids: Sequence[int],
        output_dir,
        annotations_path,
        images_path,
        processed_path,
        temp_dir=None,
        chunk_size: int = 10000,
        compression: str = "gz",
        include_images: bool = True,
        include_depth: bool = True,
        include_metadata: bool = True,
        resume: bool = False,
        upload_throttle_mbps: Optional[float] = None,
        name_prefix: str = "human36m",
    ):
        self.subject_ids = list(subject_ids)
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.annotations_path = Path(annotations_path)
        self.images_path = Path(images_path)
        self.processed_path = Path(processed_path)
        if temp_dir:
            self.temp_dir = Path(temp_dir)
            self.temp_dir.mkdir(parents=True, exist_ok=True)
            self.using_system_temp = False
        else:
            self.temp_dir = Path(tempfile.mkdtemp(prefix="h36m_chunker_"))
            self.using_system_temp = True
        self.chunk_size = chunk_size
        self.compression = compression
        self.include_images = include_images
        self.include_depth = include_depth
        self.include_metadata = include_metadata
        self.resume = resume
        self.upload_throttle_mbps = upload_throttle_mbps
        self.name_prefix = name_prefix

        self.new_samples: List[Dict] = []
        # (subject_id, file_id) aligned 1:1 with new_samples — committed
        # to processed_files per chunk at upload time (see _upload_chunk)
        self._pending_ids: List[tuple] = []
        self._pause_requested = False
        self.state = self._load_state() if resume else self._fresh_state()

    # -- state machine (reference dataset_chunker.py:141-267) ------------

    def _fresh_state(self) -> Dict:
        return {
            "subjects_processed": [],
            "processed_files": {},
            "chunks_created": [],
            "chunks_uploaded": [],
            "current_chunk": None,
        }

    def _state_path(self) -> Path:
        return self.output_dir / self.STATE_FILE

    def _load_state(self) -> Dict:
        p = self._state_path()
        if p.exists():
            try:
                with open(p) as f:
                    state = json.load(f)
                logger.info("Resumed chunker state from %s", p)
                return {**self._fresh_state(), **state}
            except Exception:
                logger.exception("Corrupt state file; starting fresh")
        return self._fresh_state()

    def _save_state(self):
        tmp = self._state_path().with_suffix(".tmp")
        with open(tmp, "w") as f:
            json.dump(self.state, f, indent=2)
        tmp.replace(self._state_path())

    # -- pause handling (reference :274-301) ------------------------------

    def install_signal_handlers(self):
        def handler(signum, frame):
            logger.warning(
                "Signal %s received: will pause after current unit.", signum
            )
            self._pause_requested = True

        signal.signal(signal.SIGINT, handler)
        signal.signal(signal.SIGTERM, handler)

    def _check_pause(self):
        if self._pause_requested:
            logger.info("Pausing: saving state and exiting cleanly.")
            self._save_state()
            raise SystemExit(0)

    # -- subject loading (reference :392-541) -----------------------------

    def _load_subject_data(self, subject_id: int) -> List[Dict]:
        logger.info("Loading data for subject %d ...", subject_id)
        base = self.annotations_path
        with open(base / f"Human36M_subject{subject_id}_data.json") as f:
            data_info = json.load(f)
        with open(base / f"Human36M_subject{subject_id}_camera.json") as f:
            camera_info = json.load(f)
        with open(base / f"Human36M_subject{subject_id}_joint_3d.json") as f:
            joint_info = json.load(f)

        processed_ids = set(
            self.state.get("processed_files", {}).get(str(subject_id), [])
        )

        annotation_lookup = {
            ann["image_id"]: ann for ann in data_info.get("annotations", [])
        }

        candidates = []
        for img in data_info.get("images", []):
            file_name = img["file_name"]
            folder = Path(file_name).parent
            stem = Path(file_name).stem
            depth_file = self.processed_path / folder / f"{stem}_depth.png"
            meta_file = self.processed_path / folder / f"{stem}.json"
            file_id = f"{img['id']}_{img.get('cam_idx')}_{img.get('frame_idx')}"
            if file_id in processed_ids:
                continue
            candidates.append((img, depth_file, meta_file, file_id))

        def build(args):
            img, depth_file, meta_file, file_id = args
            if self.include_depth and not depth_file.exists():
                return None
            if self.include_metadata and not meta_file.exists():
                return None
            ann = annotation_lookup.get(img["id"])
            if ann is None:
                return None
            try:
                cam = camera_info[str(img["cam_idx"])]
                joints_world = joint_info[str(img["action_idx"])][
                    str(img["subaction_idx"])
                ][str(img["frame_idx"])]
            except KeyError:
                return None
            joints_camera = world_to_camera_np(joints_world, cam["R"], cam["t"])
            sample = {
                "image_file": str(self.images_path / img["file_name"]),
                "depth_file": str(depth_file),
                "metadata_file": str(meta_file),
                "joints_3d": joints_camera.tolist(),
                "camera_params": {
                    "R": cam["R"], "t": cam["t"],
                    "f": cam["f"], "c": cam["c"],
                },
                "bbox": ann.get("bbox"),
                "action": img["action_idx"],
                "subaction": img["subaction_idx"],
                "frame_idx": img["frame_idx"],
                "cam_idx": img["cam_idx"],
                "subject": img.get("subject", subject_id),
            }
            return sample, file_id

        samples = []
        with ThreadPoolExecutor(max_workers=8) as ex:
            for i, out in enumerate(ex.map(build, candidates)):
                if out is not None:
                    s, fid = out
                    samples.append(s)
                    # A sample's file_id is committed to
                    # state["processed_files"] only when the chunk holding
                    # it has been UPLOADED (_upload_chunk) — committing at
                    # load time silently lost every loaded-but-unpacked
                    # sample across a pause/crash during chunk creation
                    # (review finding; the id filter at the top of this
                    # method would drop them forever on resume).
                    self._pending_ids.append((subject_id, fid))
                if i % 1000 == 0:
                    self._check_pause()
        logger.info(
            "Loaded %d new samples for subject %d", len(samples), subject_id
        )
        return samples

    # -- chunk creation (reference :616-763) ------------------------------

    def _chunk_name(self, idx: int) -> str:
        return f"{self.name_prefix}_chunk_{idx:06d}.tar.{self.compression}"

    def _next_chunk_index(self) -> int:
        indices = []
        for name in self.state["chunks_created"]:
            try:
                indices.append(int(name.split("chunk_")[1].split(".")[0]))
            except (IndexError, ValueError):
                continue
        for f in self.output_dir.glob(f"{self.name_prefix}_chunk_*.tar.*"):
            try:
                indices.append(int(f.name.split("chunk_")[1].split(".")[0]))
            except (IndexError, ValueError):
                continue
        return max(indices) + 1 if indices else 0

    def _pack_sample(self, sample: Dict, rel: str):
        """Plan one sample's archive members: rewrite its paths
        chunk-relative and list (source file, chunk-relative name) pairs
        to stream into the tar — the reference copies every file into a
        staging chunk dir first (_process_sample, :829-896); here sources
        are added straight from their original locations, removing one
        full write+read of the dataset."""
        out = dict(sample)
        adds = []
        if self.include_images:
            src = Path(sample["image_file"])
            name = f"image{src.suffix or '.jpg'}"
            out["image_file"] = f"data/{rel}/{name}"
            adds.append((src, out["image_file"]))
        if self.include_depth:
            src = Path(sample["depth_file"])
            out["depth_file"] = f"data/{rel}/depth.png"
            adds.append((src, out["depth_file"]))
        if self.include_metadata:
            src = Path(sample["metadata_file"])
            out["metadata_file"] = f"data/{rel}/metadata.json"
            adds.append((src, out["metadata_file"]))
            try:
                with open(src) as f:
                    meta = json.load(f)
                for k in ("depth_min", "depth_max", "keypoints", "image_size"):
                    if k in meta:
                        out[k] = meta[k]
            except Exception:
                logger.exception("Unreadable metadata %s", src)
        return out, adds

    def _create_chunks(self):
        start_idx = self._next_chunk_index()
        n = len(self.new_samples)
        num_chunks = (n + self.chunk_size - 1) // self.chunk_size
        if n == 0:
            logger.info("No new samples; skipping chunk creation.")
            return
        logger.info(
            "Creating %d chunks starting at index %d ...", num_chunks, start_idx
        )
        for i in range(num_chunks):
            chunk_idx = start_idx + i
            chunk_filename = self._chunk_name(chunk_idx)
            if chunk_filename in self.state["chunks_uploaded"]:
                continue
            self.state["current_chunk"] = chunk_idx
            self._save_state()

            chunk_samples = self.new_samples[
                i * self.chunk_size : (i + 1) * self.chunk_size
            ]
            chunk_dirname = f"chunk_{chunk_idx:06d}"

            # Plan members (path rewrite + metadata merge), then stream
            # sources straight into the archive — no staging copies.
            # samples.pkl goes FIRST so streaming readers
            # (count_chunk_samples) stop after one member.
            packed, adds = [], []
            for j, sample in enumerate(chunk_samples):
                out, sample_adds = self._pack_sample(sample, f"{j:06d}")
                packed.append(out)
                adds.extend(sample_adds)
                if j % 100 == 0:
                    self._check_pause()

            archive = self.temp_dir / chunk_filename
            mode = (
                f"w:{self.compression}" if self.compression != "tar" else "w"
            )
            # dereference=True: datasets linked into place (symlinked
            # image trees) must be stored as file CONTENT — a SYMTYPE
            # member has no payload and every chunk reader would drop
            # the sample (the old staging-copy path dereferenced
            # implicitly via shutil.copyfile).
            with tarfile.open(archive, mode, dereference=True) as tar:
                blob = pickle.dumps(packed)
                info = tarfile.TarInfo(f"{chunk_dirname}/samples.pkl")
                info.size = len(blob)
                tar.addfile(info, io.BytesIO(blob))
                for k, (src, rel) in enumerate(adds):
                    tar.add(src, arcname=f"{chunk_dirname}/{rel}",
                            recursive=False)
                    if k % 300 == 0:
                        self._check_pause()

            self.state["chunks_created"].append(chunk_filename)
            self._save_state()
            ids = self._pending_ids[
                i * self.chunk_size : (i + 1) * self.chunk_size
            ]
            self._upload_chunk(archive, chunk_filename, ids)
            self._check_pause()

    def _upload_chunk(self, archive: Path, chunk_filename: str,
                      sample_ids: Sequence[tuple] = ()):
        """Throttled copy to the output directory (the reference's OneDrive
        'upload', :775-827). The chunk's sample ids become 'processed' in
        the SAME state save that marks the chunk uploaded — a crash at any
        earlier point re-loads and re-packs those samples on resume (at
        worst the tiny copy-done→state-save window duplicates one chunk;
        data is never lost)."""
        dst = self.output_dir / chunk_filename
        if self.upload_throttle_mbps:
            chunk_bytes = int(self.upload_throttle_mbps * 1024 * 1024 / 10)
            with open(archive, "rb") as fin, open(dst, "wb") as fout:
                while True:
                    buf = fin.read(chunk_bytes)
                    if not buf:
                        break
                    fout.write(buf)
                    time.sleep(0.1)
        else:
            shutil.copyfile(archive, dst)
        archive.unlink()
        self.state["chunks_uploaded"].append(chunk_filename)
        for subj, fid in sample_ids:
            self.state.setdefault("processed_files", {}).setdefault(
                str(subj), []
            ).append(fid)
            if subj not in self.state["subjects_processed"]:
                self.state["subjects_processed"].append(subj)
        self._save_state()
        logger.info("Uploaded %s", chunk_filename)

    # -- top-level ---------------------------------------------------------

    def process(self):
        try:
            for sid in self.subject_ids:
                if (
                    self.resume
                    and sid in self.state["subjects_processed"]
                    and not self.state.get("processed_files", {}).get(str(sid))
                ):
                    continue
                self.new_samples.extend(self._load_subject_data(sid))
                self._save_state()
                self._check_pause()
            self._create_chunks()
        finally:
            if self.using_system_temp:
                shutil.rmtree(self.temp_dir, ignore_errors=True)
        logger.info(
            "Processing complete. Total new samples: %d", len(self.new_samples)
        )
