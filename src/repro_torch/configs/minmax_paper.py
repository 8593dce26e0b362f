"""The paper's own workload: 0-bit CWS feature hashing + linear classifier.

Data copied from the reference's ``repro.configs.minmax_paper``.  Not an
LM config: ``get_config("minmax_paper")`` selects the featurize -> train
-> score pipeline's widths and training hyperparameters.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class CWSPipelineConfig:
    name: str = "minmax_paper"
    dim: int = 256
    num_hashes: int = 1024
    b_i: int = 8
    b_t: int = 0
    n_classes: int = 10
    l2: float = 1e-5
    steps: int = 400
    lr: float = 0.05


CONFIG = CWSPipelineConfig()
SMOKE = CWSPipelineConfig(name="minmax_paper_smoke", dim=32, num_hashes=64,
                          b_i=4, n_classes=4, steps=50)
