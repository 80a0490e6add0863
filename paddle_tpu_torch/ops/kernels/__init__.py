"""paddle_tpu_torch.ops.kernels — the port's hand-written Hopper kernels.

Counterpart of ``paddle_tpu/ops/pallas``. Each kernel is CUDA C++ for
``sm_90a`` under ``paddle_tpu_torch/csrc/``, compiled by ``nvcc`` at first
use into a shared library with a plain C interface and called through
``ctypes`` (pointers from ``Tensor.data_ptr()``, the stream from
``torch.cuda.current_stream()``). Nothing is compiled or loaded when this
module is imported: the CPU has no ``nvcc``, and on a CPU tensor every
wrapper computes its kernel's plain PyTorch version instead. On a CUDA
tensor the wrapper launches the kernel or raises; it never falls back.

This module holds what the kernels share:

* :func:`configure` and :func:`enabled` — the switch that routes the
  loss, the optimizer and batch norm through their kernels, the
  counterpart of ``paddle_tpu.ops.pallas.configure``/``enabled``;
* :func:`build` — the ``nvcc`` build, one process per source, all started
  together, into :data:`BUILD_DIR` (listed in ``.gitignore``). A library
  is named after a hash of its source and flags, so an edited source is
  rebuilt and a stale library is never loaded. Kernels that share a
  source share its library.
* :data:`launches` — one plain int per kernel, incremented by the wrapper
  where it launches the kernel and nowhere else, so a run can show that
  its main path went through the kernels.
* a build lock, so that the serving batcher's thread and the main thread
  never build or load at the same time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: kernel name -> its CUDA source under ``csrc/`` (the name is also the
#: source's C entry point)
SOURCES = {
    "layer_norm_fwd": "layer_norm.cu",
    "layer_norm_bwd": "layer_norm_bwd.cu",
    "flash_attention_fwd": "flash_attention.cu",
    "flash_attention_bwd_dq": "flash_attention_bwd.cu",
    "flash_attention_bwd_dkv": "flash_attention_bwd.cu",
    "softmax_xent_fwd": "softmax_xent.cu",
    "softmax_xent_bwd": "softmax_xent.cu",
    "fused_adam": "fused_adam.cu",
    "fused_adam_multi": "fused_adam.cu",
    "fused_adam_flat": "fused_adam.cu",
    "batch_norm_stats": "batch_norm.cu",
    "batch_norm_normalize": "batch_norm.cu",
    "batch_norm_bwd_reduce": "batch_norm.cu",
    "batch_norm_bwd_dx": "batch_norm.cu",
}

# -- the kernel switch -------------------------------------------------------

#: the reference's kernel names (``paddle_tpu/ops/pallas/__init__.py``)
KERNELS = ("layer_norm", "fused_adam", "fused_adam_multi",
           "flash_attention", "softmax_xent", "batch_norm")
# Auto, on the card and on the CPU alike. Layer norm and attention have no
# other route on the card. The loss, Adam and batch-norm kernels stay off,
# as in the reference, which keeps the default training steps as they
# were measured before those kernels were ported; whether to turn them on
# is decided from the H100's numbers (ROADMAP.md Queue A). None of this is
# a TPU measurement.
_AUTO_ON = {"layer_norm": True, "flash_attention": True,
            "fused_adam": False, "fused_adam_multi": False,
            "softmax_xent": False, "batch_norm": False}
_overrides = {}


def configure(flash_min_seq=None, **kernels):
    """``configure(softmax_xent=True, fused_adam_multi=None, ...)``:
    override the auto default of named kernels; ``None`` restores auto;
    an unknown name raises ``ValueError``. ``layer_norm`` and
    ``flash_attention`` have no other route on the card, so ``False``
    raises ``NotImplementedError``, as does a sequence gate
    ``flash_min_seq`` (the reference's default is a TPU measurement).
    ``batch_norm=True`` sends a training-mode, affine, channels-last
    ``ops.nn_ops.batch_norm`` through the four batch-norm kernels. An
    override of ``True`` on a CPU tensor runs the kernel's plain
    version."""
    if flash_min_seq is not None:
        raise NotImplementedError(
            "flash_min_seq: the port runs attention through its kernel at "
            "every length; a crossover needs an H100 measurement "
            "(ROADMAP.md Queue A)")
    for k, v in kernels.items():
        if k not in KERNELS:
            raise ValueError(f"unknown kernel {k!r}; known: {KERNELS}")
        if v is None:
            _overrides.pop(k, None)
        elif k in ("layer_norm", "flash_attention") and not v:
            raise NotImplementedError(
                f"{k}=False: the port has no other route for {k} on the "
                f"card (ROADMAP.md Queue A item 3)")
        else:
            _overrides[k] = bool(v)


def enabled(kernel):
    """Whether ``kernel`` is on: its override, else its auto default."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; known: {KERNELS}")
    v = _overrides.get(kernel)
    return _AUTO_ON[kernel] if v is None else v


NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per kernel since the last :func:`reset_launches`
launches = {name: 0 for name in SOURCES}

_lock = threading.Lock()        # build and load
_count_lock = threading.Lock()
_libs = {}


def reset_launches():
    with _count_lock:
        for name in launches:
            launches[name] = 0


def count_launch(name):
    with _count_lock:
        launches[name] += 1


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(source):
    src = CSRC / source
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _build_locked(names):
    pending = []
    for source in dict.fromkeys(SOURCES[name] for name in names):
        so = _library_path(source)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending.append((source, so, tmp, proc))
    failed = []
    for source, so, tmp, proc in pending:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{source}:\n{out}")
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)  # atomic: a concurrent builder sees all or none
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def build(*names):
    """Compile every named kernel (default: all) whose library is not
    built yet, one ``nvcc`` per source, all at once. Returns
    ``{source: nvcc output}``, which includes ``-Xptxas -v``'s registers,
    shared memory and spills for each kernel of the source."""
    names = names or tuple(SOURCES)
    with _lock:
        _build_locked(names)
    logs = {}
    for source in dict.fromkeys(SOURCES[name] for name in names):
        log = _library_path(source).with_suffix(".log")
        logs[source] = log.read_text() if log.exists() else ""
    return logs


def function(name, argtypes):
    """The C entry point ``name`` of its kernel's library, built and
    loaded on first use, with ``argtypes`` set and an int return."""
    fn = _libs.get(name)
    if fn is None:
        with _lock:
            fn = _libs.get(name)
            if fn is None:
                _build_locked((name,))
                lib = ctypes.CDLL(str(_library_path(SOURCES[name])))
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                lib.ptk_error_string.argtypes = [ctypes.c_int]
                lib.ptk_error_string.restype = ctypes.c_char_p
                fn.error_string = lib.ptk_error_string
                _libs[name] = fn
    return fn


def check(name, fn, code):
    """Raise if a launch returned a CUDA error: a refused launch never
    runs, and a later synchronize would not report it."""
    if code != 0:
        msg = fn.error_string(code).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def stream_of(t):
    """PyTorch's current stream on the tensor's card, as a C pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def device_index(t):
    return t.device.index if t.device.index is not None else 0


from . import layer_norm, flash_attention, softmax_xent  # noqa: E402
from . import fused_adam, batch_norm  # noqa: E402

__all__ = ["build", "function", "launches", "reset_launches", "configure",
           "enabled", "layer_norm", "flash_attention", "softmax_xent",
           "fused_adam", "batch_norm", "SOURCES", "KERNELS", "BUILD_DIR"]
