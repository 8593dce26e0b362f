"""The paper's contribution in PyTorch: min-max kernels, (0-bit) CWS
hashing and its encodings, the kernel SVM and the embedding-bag scorer."""
from repro_torch.core.cws import (CWSParams, cws_hash, cws_hash_reference,
                                  cws_hash_regen, make_cws_params,
                                  make_cws_params_jax)
from repro_torch.core.hashing import (collision_estimate, encode,
                                      encode_tstar_only, feature_indices,
                                      full_collision_estimate, hashed_dim,
                                      one_hot_features, pack_codes,
                                      unpack_codes)
from repro_torch.core.kernels import (GRAM_FNS, intersection_gram,
                                      linear_gram, minmax_gram, minmax_pair,
                                      nminmax_gram, resemblance_gram,
                                      resemblance_pair)

__all__ = ["CWSParams", "cws_hash", "cws_hash_reference", "cws_hash_regen",
           "make_cws_params", "make_cws_params_jax", "collision_estimate", "encode",
           "encode_tstar_only", "feature_indices", "full_collision_estimate",
           "hashed_dim", "one_hot_features", "pack_codes", "unpack_codes", "GRAM_FNS",
           "intersection_gram", "linear_gram", "minmax_gram", "minmax_pair",
           "nminmax_gram", "resemblance_gram", "resemblance_pair"]
