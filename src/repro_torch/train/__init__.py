"""The LM wing's steps: serving (``build_prefill_step``,
``build_decode_step``) and the synthetic token pipeline (``make_batch``,
``TokenStream``).  Training steps are not ported yet."""
from repro_torch.train.data import TokenStream, make_batch
from repro_torch.train.serve_step import build_decode_step, build_prefill_step

__all__ = ["TokenStream", "make_batch", "build_decode_step", "build_prefill_step"]
