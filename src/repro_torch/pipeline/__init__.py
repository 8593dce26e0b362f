"""CWS -> b-bit code -> embedding-bag indices, behind the kernel registry."""
from repro_torch.pipeline.featurize import FeaturePipeline, FeatureSpec

__all__ = ["FeatureSpec", "FeaturePipeline"]
