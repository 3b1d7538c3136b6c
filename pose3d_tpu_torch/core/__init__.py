"""Configuration (counterpart of ``pose3d_tpu.core``). The JAX package's
``data_sharding`` and ``replicated`` (``jax.sharding`` objects) have no
counterpart: a step of the port takes its rows with ``mesh.batch_rows``."""

from pose3d_tpu_torch import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "GlobalConfig": "config",
    "CNNModelConfig": "config",
    "TransformerModelConfig": "config",
    "make_model_config": "config",
    "CONNECTIONS_H36M": "config",
    "CONNECTIONS_COCO": "config",
    "SYMMETRIC_JOINTS_H36M": "config",
    "make_mesh": "mesh",
})
