"""Stage 1 (2D keypoints and metric depth per image): the cached provider
and the networks' provider (counterpart of ``pose3d_tpu.stage1``). The
networks' modules are imported where they are used."""

from pose3d_tpu_torch.stage1.api import (  # noqa: F401
    CachedStage1,
    Stage1Result,
    get_stage1_provider,
)
