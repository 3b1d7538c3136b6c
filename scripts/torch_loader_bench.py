"""Host input-pipeline micro-benchmark of the PyTorch/CUDA port: chunk
access modes (counterpart of ``scripts/loader_bench.py``).

Builds one synthetic chunk in the reference's container format
(``tests/helpers_synthetic.py``) at a realistic image size and times the
chunk-access paths of ``pose3d_tpu_torch/data/chunks.py`` end to end
(archive → decoded fixed-shape arrays):

  extract    tar extraction to disk, then per-file reads (the reference's
             semantics);
  stream     the native ``chunkio`` inflates the archive into memory, the
             blobs decode from there (no disk round trip);
  stream-py  the same through Python's ``tarfile``;
  stream-u8  stream, decoded to uint8 rather than float32.

The decode goes through ``data/native.py``: the native library where it
builds (g++ with the libjpeg and libpng headers), else cv2; the route is
named in the output. Pure host code: no card, no kernel. Prints one JSON
line.

  python scripts/torch_loader_bench.py [--samples 128] [--size 500]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
for p in (REPO, REPO / "tests"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--samples", type=int, default=128)
    ap.add_argument("--size", type=int, default=500,
                    help="stored and decoded image side")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    from helpers_synthetic import make_synthetic_chunk

    from pose3d_tpu_torch.data import chunks, native

    n, hw = args.samples, (args.size, args.size)
    work = Path(tempfile.mkdtemp(prefix="loader_bench_"))
    out = {"samples": n, "size": args.size, "route": native.decode_route(),
           "native_chunkio": native.native_available()}
    try:
        print(f"building synthetic chunk: {n} samples @ {hw}", flush=True)
        tar_path, _ = make_synthetic_chunk(work, 0, num_samples=n,
                                           image_hw=hw, prefix="bench")
        out["archive_mb"] = tar_path.stat().st_size / 1e6
        print(f"archive: {out['archive_mb']:.1f} MB, decode route "
              f"{out['route']}, native chunkio {out['native_chunkio']}",
              flush=True)

        def bench(label, fn):
            best = float("inf")
            for _ in range(args.reps):
                t0 = time.perf_counter()
                count = fn()
                best = min(best, time.perf_counter() - t0)
            assert count == n, (label, count)
            print(f"{label:10s}: {best * 1e3:8.1f} ms best of {args.reps} "
                  f"({n / best:.1f} samples/s)", flush=True)
            out[f"{label}_ms"] = best * 1e3
            out[f"{label}_samples_per_sec"] = n / best
            return best

        def decode(store, **kw):
            return len(chunks.decode_chunk_samples(store.samples, store, hw,
                                                   **kw))

        def extract():
            cache = work / "cache"
            shutil.rmtree(cache, ignore_errors=True)   # cold every rep
            return decode(chunks.open_chunk_store(tar_path, cache,
                                                  mode="extract"))

        def stream():
            return decode(chunks.open_chunk_store(tar_path, mode="stream"))

        def stream_python():
            orig = native.read_chunk_members
            native.read_chunk_members = lambda p: None
            try:
                return stream()
            finally:
                native.read_chunk_members = orig

        def stream_uint8():
            return decode(chunks.open_chunk_store(tar_path, mode="stream"),
                          pixel_dtype="uint8")

        t_extract = bench("extract", extract)
        t_stream = bench("stream", stream)
        bench("stream-py", stream_python)
        t_u8 = bench("stream-u8", stream_uint8)
        print(f"stream vs extract: {t_extract / t_stream:.2f}x; uint8 vs "
              f"f32 decode: {t_stream / t_u8:.2f}x", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
