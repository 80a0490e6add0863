"""paddle_tpu_torch.inference — Config and Predictor.

Counterpart of ``paddle_tpu/inference.py``. PyTorch runs eagerly, so
there is no per-signature executable to compile; the Predictor instead
keeps ``_compiled``, the set of input signatures it has run, and
:meth:`Predictor.warmup` runs each new signature once on zeros — which
builds the port's kernels and sets up the CUDA and cuBLAS handles before
traffic arrives — so the serving engine's compile accounting keeps its
meaning: it counts signatures met for the first time.

The int8 path, ``export`` and ``compile_report`` are not ported yet.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from . import device as _device


def to_host(t):
    """A device output as a host numpy array. bf16, which numpy lacks,
    comes back as float32."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class Config:
    """Precision knob: float32, or bf16 via :meth:`enable_bf16`."""

    def __init__(self, model_path=None):
        self.model_path = model_path
        self.precision = "float32"

    def enable_bf16(self):
        self.precision = "bfloat16"
        return self


class Predictor:
    """Wraps an eval-mode Layer on one device.

    ``Predictor(model, config=None, device=None)`` moves ``model`` to
    ``device`` (default :func:`paddle_tpu_torch.device.get_device`, the
    CUDA card) and raises ``RuntimeError`` when that is CUDA and no card
    is present. With ``Config().enable_bf16()`` it serves a bf16 copy of
    the model (floating parameters cast; the caller's model is left as
    it was); outputs still reach the host as float32.
    """

    def __init__(self, model, config=None, device=None):
        if isinstance(model, Config):
            raise NotImplementedError(
                "Predictor(Config(model_path)): loading a saved model is "
                "not ported yet; pass the model")
        self.config = config or Config()
        self.device = _device.resolve(device)
        if self.config.precision == "bfloat16":
            model = copy.deepcopy(model).to(self.device,
                                            dtype=torch.bfloat16)
        elif self.config.precision == "float32":
            model = model.to(self.device)
        else:
            raise NotImplementedError(
                f"Predictor: precision {self.config.precision!r} is not "
                f"ported yet")
        self.model = model.eval()
        self._compiled = set()

    @property
    def state(self):
        """The served model's weights as ``{name: tensor}``, views of its
        own (what a serving fleet's ``swap_weights`` takes, and copies
        into each replica's model)."""
        return dict(self.model.state_dict())

    @staticmethod
    def _signature(arrays):
        return tuple((tuple(a.shape), str(a.dtype)) for a in arrays)

    def _to_device(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def run(self, *inputs, buckets=None):
        """Run inference; inputs are numpy arrays or tensors. Returns
        numpy outputs (a list when the model returns several). With
        ``buckets`` (True for powers of two, or a size list) the batch
        dim is padded up to the next bucket and outputs sliced back."""
        out = self.run_device(*inputs, buckets=buckets)
        if isinstance(out, (tuple, list)):
            return [to_host(o) for o in out]
        return to_host(out)

    def run_device(self, *inputs, buckets=None):
        """Like :meth:`run` but returns the outputs as tensors on the
        Predictor's device, without the copy to the host."""
        arrays = [self._to_device(x) for x in inputs]
        real_n = None
        if buckets and arrays and arrays[0].ndim >= 1:
            from .io.bucketing import next_bucket, pad_to_bucket
            n = arrays[0].shape[0]
            target = next_bucket(n, None if buckets is True else buckets)
            if target != n:
                real_n = n
                arrays = [pad_to_bucket(a, target)
                          if a.ndim >= 1 and a.shape[0] == n else a
                          for a in arrays]
        out = self._forward(arrays)
        self._compiled.add(self._signature(arrays))
        if real_n is not None:
            from .io.bucketing import unpad
            if isinstance(out, (tuple, list)):
                out = tuple(unpad(o, real_n) for o in out)
            else:
                out = unpad(out, real_n)
        return out

    def _forward(self, arrays):
        # grad mode is thread-local: the serving batcher calls this from
        # its own thread, so the no-grad context is entered here
        with torch.inference_mode():
            return self.model(*arrays)

    def warmup(self, *signatures):
        """Run each signature once on zeros ahead of traffic: each is a
        list with one ``(shape, dtype)`` pair (or template array) per
        model input. Returns the signature keys, as :meth:`run` computes
        them."""
        keys = []
        for sig in signatures:
            arrays = []
            for item in sig:
                if hasattr(item, "shape") and hasattr(item, "dtype"):
                    shape, dtype = item.shape, item.dtype
                else:
                    shape, dtype = item
                arrays.append(np.zeros(tuple(int(s) for s in shape),
                                       dtype=np.dtype(dtype)))
            self.run_device(*arrays)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            keys.append(self._signature(
                [torch.from_numpy(a) for a in arrays]))
        return keys
