"""Host-side batch encoding (counterpart of ``pose3d_tpu.data``). The JAX
package's ``pose3d_tpu.data`` is not imported: its ``__init__`` loads the
chunk reader and OpenCV."""
