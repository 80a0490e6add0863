"""paddle_tpu_torch.ops — functional ops and the hand-written kernels."""
from . import kernels, loss, math, nn_ops

__all__ = ["kernels", "loss", "math", "nn_ops"]
