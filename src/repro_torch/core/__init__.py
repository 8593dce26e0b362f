"""CWS hashing, encodings and the embedding-bag scorer, in PyTorch."""
from repro_torch.core.cws import (CWSParams, cws_hash, cws_hash_reference,
                                  cws_hash_regen, make_cws_params)
from repro_torch.core.hashing import (encode, feature_indices, hashed_dim,
                                      pack_codes, unpack_codes)

__all__ = ["CWSParams", "cws_hash", "cws_hash_reference", "cws_hash_regen",
           "make_cws_params", "encode", "feature_indices", "hashed_dim",
           "pack_codes", "unpack_codes"]
