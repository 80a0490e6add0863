"""paddle_tpu_torch.ops — functional ops and the hand-written kernels."""
from . import kernels, nn_ops

__all__ = ["kernels", "nn_ops"]
