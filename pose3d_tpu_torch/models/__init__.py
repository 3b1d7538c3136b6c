"""Lifting models (counterpart of ``pose3d_tpu.models``)."""

from pose3d_tpu_torch.models.cnn import CNNPoseEstimation
from pose3d_tpu_torch.models.factory import build_model, dummy_inputs
from pose3d_tpu_torch.models.transformer import TransformerPoseEstimation

__all__ = ["build_model", "dummy_inputs", "CNNPoseEstimation",
           "TransformerPoseEstimation"]
