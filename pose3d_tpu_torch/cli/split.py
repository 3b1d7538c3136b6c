"""Train/test split CLI — equivalent of the reference's ``dataset_split.py``
(same semantics; local directories replace the hard rclone dependency —
point ``--input-dir``/``--output-dir`` at an rclone mount or use rclone
separately for transfer; reference dataset_split.py:423-434).

Counterpart of ``pose3d_tpu/cli/split.py``, the same flags, defaults and
choices. Host only. Run as ``python -m pose3d_tpu_torch.cli.split``.
"""

from __future__ import annotations

import argparse
import logging

from pose3d_tpu_torch.data.rechunk import DatasetSplitter


def build_parser():
    p = argparse.ArgumentParser(
        description="Split chunked dataset into train/test by subject and "
                    "rechunk"
    )
    p.add_argument("--input-dir", required=True, type=str,
                   help="Directory containing original .tar chunks")
    p.add_argument("--output-dir", required=True, type=str,
                   help="Output root; train/ and test/ subdirs are created")
    p.add_argument("--staging-dir", type=str, default=None,
                   help="Local staging dir for resume state and extraction")
    p.add_argument("--train-subjects", required=True, type=str,
                   help="Comma-separated subject IDs for training")
    p.add_argument("--test-subjects", required=True, type=str,
                   help="Comma-separated subject IDs for testing")
    p.add_argument("--subject-id-key", default="subject")
    p.add_argument("--new-chunk-size", type=int, default=1000)
    p.add_argument("--output-compression", default="gz",
                   choices=["gz", "bz2", "xz", "tar"])
    p.add_argument("--no-resume", action="store_false", dest="resume")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO, force=True)
    args = build_parser().parse_args(argv)
    splitter = DatasetSplitter(
        input_dir=args.input_dir,
        output_dir=args.output_dir,
        train_subjects=[int(s) for s in args.train_subjects.split(",")],
        test_subjects=[int(s) for s in args.test_subjects.split(",")],
        staging_dir=args.staging_dir,
        new_chunk_size=args.new_chunk_size,
        compression=args.output_compression,
        subject_key=args.subject_id_key,
        resume=args.resume,
    )
    counters = splitter.run()
    print(f"Done: {counters}")
    return counters


def cli(argv=None) -> int:
    """Console-script entry: returns 0 (``main`` returns the counters)."""
    main(argv)
    return 0

if __name__ == "__main__":
    main()
