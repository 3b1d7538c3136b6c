"""Host input pipeline (counterpart of ``pose3d_tpu.data``): chunk stores
and decoding (``chunks``, ``native``), the streaming dataset and batch
loader (``pipeline``), collation and the transfer encoding (``collate``),
host augmentation (``augment``), and the dataset tools that write the
archives (``chunker``, ``rechunk``). Numpy only; OpenCV is imported only
where it decodes or augments. The JAX
package's ``pose3d_tpu.data`` is not imported: its ``__init__`` loads the
chunk reader and OpenCV."""
