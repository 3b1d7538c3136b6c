"""Training of the lifter (counterpart of ``pose3d_tpu.train``)."""

from pose3d_tpu_torch import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "TrainState": "state",
    "create_train_state": "state",
    "make_train_step": "step",
    "make_eval_step": "step",
    "train_model": "loop",
    "save_checkpoint": "checkpoint",
    "load_checkpoint": "checkpoint",
})
