"""paddle_tpu_torch.io — save and load, and shape bucketing.

Counterpart of ``paddle_tpu/io/__init__.py``'s state-dict and
inference-model halves (``_to_numpy_tree``, ``save``, ``load``,
``save_dygraph`` / ``load_dygraph``, ``save_inference_model`` /
``load_inference_model``) and of its ``bucketing``. A saved state dict is
the reference's file: a pickle of numpy arrays, each tensor copied to the
host in its dtype (bf16 as ``ml_dtypes.bfloat16``, which is what the JAX
package's bf16 arrays are), so a file written by either package loads in
the other with the same arrays and dtypes. ``.pdmodel`` pickles the
port's own layer (the reference pickles its own): a CPU copy, so that a
model saved from the card loads on a machine without one.

Not ported: ``CheckpointManager`` and ``orbax_save`` / ``orbax_restore``
(ROADMAP.md Queue A item 19), ``DataLoader`` and the readers (item 15),
and the static program's ``save_vars`` family (item 18).
"""
from __future__ import annotations

import copy
import os
import pickle

import torch

from . import bucketing
from .bucketing import (batch_mask, next_bucket, pad_to_bucket,  # noqa: F401
                        split_rows, unpad)

__all__ = ["bucketing", "save", "load", "save_dygraph", "load_dygraph",
           "save_inference_model", "load_inference_model"]


def _to_numpy_tree(obj):
    """``obj`` with every tensor replaced by a host numpy copy of it."""
    from ..convert import to_numpy
    if isinstance(obj, torch.Tensor):
        return to_numpy(obj)
    if isinstance(obj, dict):
        return {k: _to_numpy_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy_tree(v) for v in obj)
    return obj


def save(obj, path, protocol=4):
    """``paddle.save``: pickle ``obj`` (a state dict, or any tree of dicts,
    lists and tensors) with its tensors as numpy arrays."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_numpy_tree(obj), f, protocol=protocol)


def load(path):
    """What :func:`save` wrote (numpy arrays, as the reference returns
    them; :meth:`~paddle_tpu_torch.nn.Layer.set_state_dict` takes them)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def save_dygraph(state_dict, model_path):
    """Model state to ``model_path + ".pdparams"``, optimizer state to
    ``".pdopt"``: an optimizer's dict is recognised, as the reference
    recognises it, by its slot keys (``"param@slot"``, ``"__aux__"``, a
    bare ``"lr"``)."""
    suffix = ".pdparams"
    keys = [k for k in state_dict if isinstance(k, str)]
    if keys and any("@" in k or k.startswith("__") or k == "lr"
                    for k in keys):
        suffix = ".pdopt"
    save(state_dict, model_path + suffix)


def load_dygraph(model_path):
    """``(param_dict, opt_dict)``, each None where its file is absent."""
    params = load(model_path + ".pdparams") if os.path.exists(
        model_path + ".pdparams") else None
    opt = load(model_path + ".pdopt") if os.path.exists(
        model_path + ".pdopt") else None
    return params, opt


def _cpu_copy(layer):
    """A copy of ``layer`` whose parameters and buffers live on the CPU,
    made without a second copy of them on their own device."""
    memo = {}
    for t in list(layer.parameters()) + list(layer.buffers()):
        if id(t) not in memo:
            cpu = t.detach().cpu()
            memo[id(t)] = torch.nn.Parameter(
                cpu, requires_grad=t.requires_grad) \
                if isinstance(t, torch.nn.Parameter) else cpu
    return copy.deepcopy(layer, memo)


def save_inference_model(path_prefix, layer, input_spec=None):
    """``path_prefix + ".pdmodel"``: the whole layer pickled (structure and
    weights; a CPU copy, in eval mode); ``".pdiparams"``: its state dict,
    as :func:`save` writes it. ``input_spec`` is taken and not used, as
    in the reference."""
    d = os.path.dirname(path_prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    layer.eval()
    with open(path_prefix + ".pdmodel", "wb") as f:
        pickle.dump(_cpu_copy(layer), f, protocol=4)
    save(layer.state_dict(), path_prefix + ".pdiparams")


def load_inference_model(path_prefix):
    """The layer :func:`save_inference_model` wrote, on the CPU, its
    state set from ``.pdiparams``, in eval mode."""
    with open(path_prefix + ".pdmodel", "rb") as f:
        layer = pickle.load(f)
    layer.set_state_dict(load(path_prefix + ".pdiparams"))
    return layer.eval()
