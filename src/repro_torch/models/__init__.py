from repro_torch.models.config import ModelConfig, MoECfg, SSMCfg
from repro_torch.models.model import (cast_params, decode_step, forward,
                                      init_caches, init_model, prefill,
                                      train_loss)

__all__ = ["ModelConfig", "MoECfg", "SSMCfg", "init_model", "forward",
           "prefill", "decode_step", "init_caches", "cast_params",
           "train_loss"]
