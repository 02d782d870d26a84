"""The fused 2-bit decode + standardize + GEMM kernel.

``gwas_dot`` (the submodule) holds the CUDA wrapper ``gwas_dot_fused`` and its
launch counter; ``ops`` the public ``ops.gwas_dot`` and the host/device byte
helpers; ``ref`` the plain PyTorch version.
"""
from repro_torch.kernels.gwas_dot.ops import (
    marker_stats_from_codes,
    pack_tiled,
    repack_plink_tiled,
    unpack_plink_to_codes,
)
from repro_torch.kernels.gwas_dot.ref import decode_standardize_ref, gwas_dot_ref

__all__ = [
    "gwas_dot_ref",
    "decode_standardize_ref",
    "marker_stats_from_codes",
    "pack_tiled",
    "repack_plink_tiled",
    "unpack_plink_to_codes",
]
