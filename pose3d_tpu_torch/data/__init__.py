"""Host input pipeline (counterpart of ``pose3d_tpu.data``): chunk stores
and decoding (``chunks``, ``native``), the streaming dataset and batch
loader (``pipeline``), collation and the transfer encoding (``collate``),
host augmentation (``augment``), and the dataset tools that write the
archives (``chunker``, ``rechunk``). Numpy only; OpenCV is imported only
where it decodes or augments. The JAX
package's ``pose3d_tpu.data`` is not imported: its ``__init__`` loads the
chunk reader and OpenCV. The names it exports are re-exported here and
loaded at first use, so importing this package loads neither."""

from pose3d_tpu_torch import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "list_chunk_files": "chunks",
    "extract_chunk": "chunks",
    "load_chunk_samples": "chunks",
    "open_chunk_store": "chunks",
    "decode_sample": "chunks",
    "decode_chunk_samples": "chunks",
    "StreamingChunkedDataset": "pipeline",
    "BatchLoader": "pipeline",
    "collate_fixed": "collate",
})
