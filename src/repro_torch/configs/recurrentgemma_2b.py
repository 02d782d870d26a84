"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427]: RG-LRU recurrence + local
attention in a (rec, rec, local) pattern, MQA kv=1, GeGLU."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    activation="geglu",
    tie_embeddings=True,
    embed_scale=True,
    norm_plus_one=True,
    block_pattern=("rec", "rec", "local"),
    local_window=2048,
    lru_width=2560,
    conv_width=4,
)
