"""Shuffle/rechunk CLI — equivalent of the reference's
``dataset_rechunker.py`` (same flags, reference dataset_rechunker.py:394-405).

Counterpart of ``pose3d_tpu/cli/rechunker.py``, the same flags, defaults and
choices. Host only. Run as ``python -m pose3d_tpu_torch.cli.rechunker``.
"""

from __future__ import annotations

import argparse
import logging

from pose3d_tpu_torch.data.rechunk import DatasetShuffler


def build_parser():
    p = argparse.ArgumentParser(
        description="Globally shuffle and rechunk a chunked dataset"
    )
    p.add_argument("--input-dir", required=True, type=str)
    p.add_argument("--output-dir", required=True, type=str)
    p.add_argument("--extracted-originals-dir", type=str, default=None)
    p.add_argument("--chunk-size", type=int, default=10000)
    p.add_argument("--output-compression", type=str, default="gz",
                   choices=["gz", "bz2", "xz", "tar"])
    p.add_argument("--keep-extracted-originals", action="store_true")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO, force=True)
    args = build_parser().parse_args(argv)
    shuffler = DatasetShuffler(
        input_dir=args.input_dir,
        output_dir=args.output_dir,
        chunk_size=args.chunk_size,
        compression=args.output_compression,
        extracted_originals_dir=args.extracted_originals_dir,
        keep_extracted_originals=args.keep_extracted_originals,
        num_workers=args.num_workers,
        seed=args.seed,
    )
    n = shuffler.run()
    print(f"Shuffled {n} samples")
    return n


def cli(argv=None) -> int:
    """Console-script entry: returns 0 (``main`` returns the sample
    count)."""
    main(argv)
    return 0

if __name__ == "__main__":
    main()
