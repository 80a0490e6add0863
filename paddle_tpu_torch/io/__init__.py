"""paddle_tpu_torch.io — input helpers (this slice: shape bucketing)."""
from . import bucketing

__all__ = ["bucketing"]
