"""The paper's own benchmark workload (§3.1): 8.9M markers x 23k samples x
20,480 phenotypes, fused 2-bit engine, marker x phenotype sharding."""
from repro_torch.configs.base import GwasWorkloadConfig

CONFIG = GwasWorkloadConfig()
