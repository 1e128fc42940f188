"""Sample-quality metrics (port of the numpy part of
qdiffusion_tpu/metrics)."""

from qdiffusion_torch.metrics.fid import (
    compute_statistics,
    fid_from_features,
    frechet_distance,
    inception_score_from_logits,
)

__all__ = ["compute_statistics", "frechet_distance", "fid_from_features",
           "inception_score_from_logits"]
