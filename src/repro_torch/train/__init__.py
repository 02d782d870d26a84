"""The LM wing's steps: training (``build_train_step``, ``init_train_state``
and AdamW), serving (``build_prefill_step``, ``build_decode_step``) and the
synthetic token pipeline (``make_batch``, ``TokenStream``)."""
from repro_torch.train.data import TokenStream, make_batch
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.serve_step import build_decode_step, build_prefill_step
from repro_torch.train.train_step import TrainStepConfig, build_train_step, init_train_state

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "TrainStepConfig",
    "build_train_step",
    "init_train_state",
    "build_decode_step",
    "build_prefill_step",
    "TokenStream",
    "make_batch",
]
