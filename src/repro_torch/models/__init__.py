from repro_torch.models.config import ModelConfig, MoECfg, SSMCfg
from repro_torch.models.model import (cast_params, decode_step, forward,
                                      init_caches, init_model, prefill,
                                      train_loss)
from repro_torch.models.moe import init_moe, moe_mlp
from repro_torch.models.rglru import RGLRUState, init_rglru, rglru_block
from repro_torch.models.ssm import SSMState, init_ssm, ssm_block

__all__ = ["ModelConfig", "MoECfg", "SSMCfg", "init_model", "forward",
           "prefill", "decode_step", "init_caches", "cast_params",
           "train_loss", "init_moe", "moe_mlp", "SSMState", "init_ssm",
           "ssm_block", "RGLRUState", "init_rglru", "rglru_block"]
