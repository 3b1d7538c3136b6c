"""Dataset chunker CLI — equivalent of the reference's ``dataset_chunker.py``
entry point (same flags, reference dataset_chunker.py:899-972, plus explicit
path flags replacing the reference's hardcoded config.py paths).

Counterpart of ``pose3d_tpu/cli/chunker.py``, the same flags, defaults and
choices. Host only. Run as ``python -m pose3d_tpu_torch.cli.chunker``.
"""

from __future__ import annotations

import argparse
import logging

from pose3d_tpu_torch.data.chunker import Human36MChunker


def build_parser():
    p = argparse.ArgumentParser(
        description="Process Human3.6M dataset into chunks"
    )
    p.add_argument("--subjects", type=int, nargs="+",
                   default=[1, 5, 6, 7, 8, 9, 11])
    p.add_argument("--output", type=str, default="./chunked_dataset")
    p.add_argument("--temp", type=str, default=None)
    p.add_argument("--chunk-size", type=int, default=10000)
    p.add_argument("--compression", type=str, default="gz",
                   choices=["gz", "bz2", "xz"])
    p.add_argument("--no-images", action="store_false", dest="include_images")
    p.add_argument("--no-depth", action="store_false", dest="include_depth")
    p.add_argument("--no-metadata", action="store_false",
                   dest="include_metadata")
    p.add_argument("--resume", action="store_true")
    # paths (reference config.py:36-39 hardcodes these)
    p.add_argument("--annotations-path", type=str, required=True)
    p.add_argument("--images-path", type=str, required=True)
    p.add_argument("--processed-path", type=str, required=True)
    p.add_argument("--upload-throttle-mbps", type=float, default=None)
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO, force=True)
    args = build_parser().parse_args(argv)
    chunker = Human36MChunker(
        subject_ids=args.subjects,
        output_dir=args.output,
        annotations_path=args.annotations_path,
        images_path=args.images_path,
        processed_path=args.processed_path,
        temp_dir=args.temp,
        chunk_size=args.chunk_size,
        compression=args.compression,
        include_images=args.include_images,
        include_depth=args.include_depth,
        include_metadata=args.include_metadata,
        resume=args.resume,
        upload_throttle_mbps=args.upload_throttle_mbps,
    )
    chunker.install_signal_handlers()
    chunker.process()


def cli(argv=None) -> int:
    """Console-script entry: returns 0 once the chunker has run."""
    main(argv)
    return 0

if __name__ == "__main__":
    main()
