"""Streaming chunked input pipeline, host side (counterpart of
``pose3d_tpu/data/pipeline.py``; numpy only).

A background prefetcher thread reads and decodes whole chunks into a
bounded queue while the consumer iterates the previous chunk; chunks are
split over shards round-robin by (shard_id, num_shards); ``BatchLoader``
emits fixed-shape numpy batches, each stamped with ``_pos`` (epoch, raw
samples consumed), the data position a checkpoint records.

``use_augmentation`` runs the host ``PoseAugmentor`` (``data/augment.py``,
``augmentation_config`` its keywords) over each sample of a dataset whose
``training`` is set, in the consumer's thread, as the JAX package does.
"""

from __future__ import annotations

import logging
import queue
import random
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

from pose3d_tpu_torch.data.chunks import (
    chunk_id_from_filename,
    count_chunk_samples,
    decode_chunk_samples,
    list_chunk_files,
    open_chunk_store,
)
from pose3d_tpu_torch.data.collate import collate_fixed

logger = logging.getLogger("pose3d_tpu_torch.data")


class ChunkPrefetcher:
    """Background thread: extract chunk → decode all samples (thread pool)
    → bounded queue (reference chunked_dataset.py:267-399)."""

    def __init__(
        self,
        chunk_files: Sequence[Path],
        cache_dir,
        image_size=(500, 500),
        max_chunks_in_memory: int = 2,
        decode_workers: int = 8,
        chunk_timeout_s: float = 300.0,
        root_relative: bool = True,
        decode_group: int = 64,
        shuffle_seed: Optional[int] = None,
        skip_samples: int = 0,
        chunk_io: str = "auto",
        pixel_dtype: str = "float32",
    ):
        self.chunk_files = [Path(f) for f in chunk_files]
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.image_size = tuple(image_size)
        self.decode_workers = decode_workers
        self.chunk_timeout_s = chunk_timeout_s
        self.root_relative = root_relative
        # Sub-chunk pipelining: decode the (pre-shuffled) chunk in groups of
        # ``decode_group`` samples and enqueue each group as it completes,
        # so the consumer starts after ~group-decode latency instead of
        # whole-chunk latency (the reference preprocesses the entire chunk
        # first, chunked_dataset.py:347-358). Pre-shuffling the sample list
        # preserves the reference's within-chunk shuffle semantics.
        self.decode_group = decode_group
        self.shuffle_seed = shuffle_seed
        # Deterministic mid-epoch resume: fast-forward this many samples of
        # the (shuffled) stream before emitting anything. Chunks that are
        # skipped entirely are never extracted or decoded — only their
        # sample COUNT is read (chunks.count_chunk_samples), and the shared
        # shuffle RNG is advanced by an equivalent shuffle of [0..n) so the
        # ordering of every subsequent chunk matches the original epoch.
        self.skip_samples = int(skip_samples)
        # "stream" reads each archive straight into memory (native
        # chunkio.cc / tarfile streaming — no extract-to-disk); "extract"
        # is the reference's cache-dir extraction; "auto" streams but
        # reuses an existing extracted copy (chunks.open_chunk_store).
        self.chunk_io = chunk_io
        # "uint8" keeps decoded pixels in byte form all the way to the
        # device transfer (4× less queue memory; see
        # chunks.decode_chunk_samples).
        self.pixel_dtype = pixel_dtype

        # queue holds decoded GROUPS; scale capacity accordingly
        self.chunk_queue: "queue.Queue" = queue.Queue(
            maxsize=max(2, max_chunks_in_memory * 16)
        )
        self.stop_event = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self.stop_event.is_set():
            try:
                self.chunk_queue.put(item, timeout=1.0)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        from concurrent.futures import ThreadPoolExecutor

        rng = random.Random(self.shuffle_seed)
        skip = self.skip_samples
        files = list(self.chunk_files)
        # 1-deep archive read-ahead: while chunk i's samples decode, a
        # side thread already inflates chunk i+1's archive (zlib / the
        # native chunkio call both release the GIL, so this genuinely
        # overlaps with the decode pool). Read-ahead only begins once the
        # resume fast-forward is resolved — a chunk that will be skipped
        # must never be inflated; any remaining skip always exhausts
        # within the chunk being consumed, so its successor is safe.
        io_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="chunkio_readahead"
        )
        pending: Dict[int, object] = {}

        def _submit(idx: int):
            if 0 <= idx < len(files) and idx not in pending:
                pending[idx] = io_pool.submit(
                    open_chunk_store, files[idx], self.cache_dir,
                    mode=self.chunk_io,
                )

        # Raw-stream position of the epoch (counts RAW shuffled samples,
        # including resume-skipped ones and samples later dropped by
        # decode errors) — attached to every decoded record as
        # ``_raw_pos`` = number of raw samples consumed once this record
        # is consumed. skip_next_samples skips raw samples, so resume
        # positions must be recorded in the same units (a decoded-sample
        # count drifts by one for every drop).
        raw_consumed = skip  # partial-chunk skip counts as consumed
        try:
            for i, chunk_file in enumerate(files):
                if self.stop_event.is_set():
                    return
                try:
                    chunk_id = chunk_id_from_filename(chunk_file)
                    if skip > 0:
                        # Whole-chunk fast-forward without extract/decode.
                        n = count_chunk_samples(chunk_file, self.cache_dir)
                        if skip >= n:
                            if self.shuffle_seed is not None:
                                # random.shuffle draws depend only on
                                # len(): advancing on an index list
                                # reproduces the exact RNG state of
                                # shuffling the real list.
                                rng.shuffle(list(range(n)))
                            skip -= n
                            logger.info(
                                "resume fast-forward: skipped chunk %d "
                                "(%d samples, %d remaining)",
                                chunk_id, n, skip,
                            )
                            continue
                    fut = pending.pop(i, None)
                    store = (
                        fut.result() if fut is not None
                        else open_chunk_store(
                            chunk_file, self.cache_dir, mode=self.chunk_io
                        )
                    )
                    _submit(i + 1)  # inflate the next archive while
                    # this chunk decodes
                    samples = list(store.samples)
                    if self.shuffle_seed is not None:
                        rng.shuffle(samples)
                    if skip > 0:
                        logger.info(
                            "resume fast-forward: skipping %d/%d samples "
                            "of chunk %d", skip, len(samples), chunk_id,
                        )
                        samples = samples[skip:]
                        skip = 0
                    chunk_base = raw_consumed
                    raw_consumed += len(samples)
                    n_dec = 0
                    g = self.decode_group
                    for lo in range(0, len(samples), g):
                        if self.stop_event.is_set():
                            return
                        decoded = decode_chunk_samples(
                            samples[lo : lo + g], store, self.image_size,
                            num_threads=self.decode_workers,
                            root_relative=self.root_relative,
                            pixel_dtype=self.pixel_dtype,
                        )
                        for rec in decoded:
                            rec["_raw_pos"] = (
                                chunk_base + lo + rec.pop("_src_index") + 1
                            )
                        n_dec += len(decoded)
                        if decoded and not self._put((chunk_id, decoded)):
                            return
                    logger.info(
                        "chunk %d: decoded %d/%d samples",
                        chunk_id, n_dec, len(samples),
                    )
                except Exception:
                    logger.exception(
                        "Error prefetching chunk %s", chunk_file
                    )
                    continue
            if skip > 0:
                logger.warning(
                    "resume fast-forward exhausted the chunk list with %d "
                    "samples still to skip — the dataset is smaller than "
                    "when the checkpoint was written; this epoch yields "
                    "nothing.", skip,
                )
            self._put(None)  # sentinel: no more chunks
        finally:
            for fut in pending.values():
                fut.cancel()
            io_pool.shutdown(wait=False)

    def get_next_chunk(self):
        """Next (chunk_id, samples) or None at end-of-stream / timeout
        (reference chunked_dataset.py:371-379)."""
        try:
            return self.chunk_queue.get(timeout=self.chunk_timeout_s)
        except queue.Empty:
            logger.warning("Timeout waiting for next chunk")
            return None

    def close(self):
        self.stop_event.set()
        while True:
            try:
                self.chunk_queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5)


class StreamingChunkedDataset:
    """Iterable over decoded samples streamed from tar chunks
    (reference chunked_dataset.py:402-541).

    Args mirror the reference's; ``shard_id``/``num_shards`` generalize the
    DataLoader-worker chunk split to per-host sharding.
    """

    def __init__(
        self,
        prefix: str,
        chunks_dir,
        chunk_indices: Optional[Sequence[int]] = None,
        image_size=(500, 500),
        use_augmentation: bool = False,
        augmentation_config: Optional[Dict] = None,
        cache_dir=None,
        max_chunks_in_memory: int = 2,
        shuffle: bool = True,
        shuffle_chunks: bool = True,
        seed: int = 42,
        shard_id: int = 0,
        num_shards: int = 1,
        decode_workers: int = 8,
        root_relative: bool = True,
        chunk_io: str = "auto",
        pixel_dtype: str = "float32",
    ):
        self.image_size = tuple(image_size)
        self.shuffle = shuffle
        self.shuffle_chunks = shuffle_chunks
        self.seed = seed
        self.training = False
        self.dataset_name = "Human3.6M"
        self.num_joints = 17

        self.chunk_files = list_chunk_files(chunks_dir, prefix, chunk_indices)
        logger.info("Found %d chunk files", len(self.chunk_files))

        # Shard chunks across hosts, round-robin (generalizes the
        # reference's per-worker split, chunked_dataset.py:511-514). The
        # reference-style contiguous ceil split can hand trailing hosts
        # ZERO chunks (5 files / 4 shards → 2,2,1,0) — a process with no
        # batches never joins the collectives and the job hangs;
        # round-robin gives every shard ≥1 chunk whenever there are at
        # least num_shards files, and we fail loudly otherwise.
        if num_shards > 1:
            if len(self.chunk_files) < num_shards:
                raise ValueError(
                    f"{len(self.chunk_files)} chunk files cannot be "
                    f"sharded over {num_shards} shards — every shard needs "
                    "at least one chunk or the job deadlocks"
                )
            self.chunk_files = self.chunk_files[shard_id::num_shards]

        self.augmentor = None
        if use_augmentation:
            from pose3d_tpu_torch.data.augment import PoseAugmentor

            self.augmentor = PoseAugmentor(**(augmentation_config or {}))

        if cache_dir:
            self.cache_dir = Path(cache_dir) / prefix / f"shard_{shard_id}"
            self.cache_dir.mkdir(parents=True, exist_ok=True)
            self._own_tempdir = False
        else:
            self.cache_dir = Path(tempfile.mkdtemp(prefix="pose3d_chunks_"))
            self._own_tempdir = True

        self.max_chunks_in_memory = max_chunks_in_memory
        self.decode_workers = decode_workers
        self.root_relative = root_relative
        self.chunk_io = chunk_io
        self.pixel_dtype = pixel_dtype
        self._epoch = 0
        self.current_epoch = 0
        self.current_epoch_base = 0
        self._skip_next = 0

    def __len__(self):
        # Estimated length: nominal 1000 samples/chunk
        # (reference chunked_dataset.py:485).
        return 1000 * len(self.chunk_files)

    def __del__(self):
        if getattr(self, "_own_tempdir", False):
            shutil.rmtree(self.cache_dir, ignore_errors=True)

    def set_epoch(self, epoch: int) -> None:
        """Pin the epoch used by the NEXT ``__iter__`` (deterministic
        resume: the per-epoch stream order is a pure function of
        ``(seed, epoch)`` — chunk-order shuffle and within-chunk shuffles
        both derive from ``Random(seed + epoch)``)."""
        self._epoch = int(epoch)

    def skip_next_samples(self, n: int) -> None:
        """Fast-forward the NEXT ``__iter__`` by ``n`` samples of its
        (shuffled) stream — consumed once; later epochs start clean.
        Entirely-skipped chunks are neither extracted nor decoded."""
        self._skip_next = int(n)

    def __iter__(self) -> Iterator[Dict]:
        self.current_epoch = self._epoch
        rng = random.Random(self.seed + self._epoch)
        self._epoch += 1
        skip, self._skip_next = self._skip_next, 0
        # Samples of this epoch consumed BEFORE this iterator (resume
        # fast-forward) — positions reported downstream must include it,
        # or a checkpoint taken after a resume would record a position
        # relative to the truncated stream instead of the epoch.
        self.current_epoch_base = skip
        files = list(self.chunk_files)
        if self.shuffle_chunks:
            rng.shuffle(files)
        prefetcher = ChunkPrefetcher(
            files,
            self.cache_dir,
            image_size=self.image_size,
            max_chunks_in_memory=self.max_chunks_in_memory,
            decode_workers=self.decode_workers,
            root_relative=self.root_relative,
            # within-chunk shuffle happens by pre-shuffling the sample list
            # before grouped decode (sub-chunk pipelining)
            shuffle_seed=rng.randrange(2**31) if self.shuffle else None,
            skip_samples=skip,
            chunk_io=self.chunk_io,
            pixel_dtype=self.pixel_dtype,
        )
        try:
            while True:
                item = prefetcher.get_next_chunk()
                if item is None:
                    return
                _, samples = item
                for s in samples:
                    if self.augmentor is not None and self.training:
                        pos = s.get("_raw_pos")
                        s = self.augmentor(s)
                        if pos is not None:  # survive augmentor rebuilds
                            s["_raw_pos"] = pos
                    yield s
        finally:
            prefetcher.close()


# how long closing a BatchLoader iterator waits for its feeder thread
FEEDER_JOIN_S = 30.0


class _FeederError:
    """Queue marker carrying a feeder-thread exception to the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


class BatchLoader:
    """Batches a sample iterable into fixed-shape numpy batches, with a
    background thread keeping ``prefetch`` batches ready (the role of the
    reference's DataLoader prefetch_factor, main.py:185-193)."""

    def __init__(
        self,
        dataset: StreamingChunkedDataset,
        batch_size: int,
        image_size=None,
        drop_last: bool = True,
        prefetch: int = 2,
        loop: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.image_size = image_size or dataset.image_size
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.loop = loop

    def _pos_for(self, buf: List[Dict], consumed_fallback: int):
        """Stream position for deterministic resume — (epoch, raw samples
        consumed once this batch is done). Prefers the last sample's
        ``_raw_pos`` (raw-stream units, robust to decode-dropped
        samples); falls back to counting yielded samples for sources
        that don't attach positions. Host-only metadata — dropped by
        device_batch/_superbatches' key filters."""
        raw = buf[-1].get("_raw_pos")
        return (
            getattr(self.dataset, "current_epoch", 0),
            raw if raw is not None else (
                getattr(self.dataset, "current_epoch_base", 0)
                + consumed_fallback
            ),
        )

    def _batches_once(self):
        buf: List[Dict] = []
        batch_idx = 0
        for sample in self.dataset:
            buf.append(sample)
            if len(buf) == self.batch_size:
                b = collate_fixed(buf, self.image_size)
                b["_pos"] = self._pos_for(
                    buf, (batch_idx + 1) * self.batch_size
                )
                yield b
                batch_idx += 1
                buf = []
        if buf and not self.drop_last:
            b = collate_fixed(buf, self.image_size)
            b["_pos"] = self._pos_for(
                buf, batch_idx * self.batch_size + len(buf)
            )
            yield b

    def _batches(self):
        while True:
            yield from self._batches_once()
            if not self.loop:
                return

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def feeder():
            err = None
            try:
                for b in self._batches():
                    while not stop.is_set():
                        try:
                            q.put(b, timeout=1.0)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # propagated to the consumer below
                err = e
                logger.exception("BatchLoader feeder failed")
            finally:
                # End-of-stream sentinel, or the captured error — a bare
                # swallow here made any data-pipeline exception look like
                # a clean (truncated) epoch to the training loop (wrong
                # step counts, checkpoint positions, LR schedule).
                sentinel = _FeederError(err) if err is not None else None
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=1.0)
                        return
                    except queue.Full:
                        continue

        t = threading.Thread(target=feeder, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is None:
                    return
                if isinstance(b, _FeederError):
                    raise RuntimeError(
                        "data pipeline failed in the feeder thread"
                    ) from b.error
                yield b
        finally:
            stop.set()
            # Wait for the feeder: on its way out it closes the dataset's
            # iterator, whose chunk prefetcher stops its decode thread. A
            # process that exits while that daemon thread is inside cv2's
            # decode aborts ("terminate called without an active
            # exception", exit -6), which is how a finished cli.main ended
            # on a host that decodes through cv2.
            deadline = time.monotonic() + FEEDER_JOIN_S
            while t.is_alive() and time.monotonic() < deadline:
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
