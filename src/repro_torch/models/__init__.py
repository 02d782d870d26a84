"""The LM architecture zoo: one implementation per family, one dispatch
surface (``repro_torch.models.api``) for the serve steps and the tests."""
from repro_torch.models import api

__all__ = ["api"]
