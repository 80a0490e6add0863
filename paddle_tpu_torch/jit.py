"""paddle_tpu_torch.jit — ``to_static``.

Counterpart of ``paddle_tpu.jit.to_static``, which traces a dygraph step
into one compiled XLA computation. PyTorch runs eagerly and the port's
kernels are launched one by one, so here ``to_static`` keeps the
signature and the contract a caller sees (the models it is given are put
in train mode; the optimizers' state persists across calls) and runs the
step function eagerly on the card. Capturing the step into a CUDA graph,
the port's counterpart of the compiled step, is ROADMAP.md Queue A item 5,
not this module's work yet.
"""
from __future__ import annotations

import functools


def to_static(function=None, input_spec=None, models=None, optimizers=None,
              donate_state=True, scalers=None, bucket=False, buckets=None,
              pad_mode="repeat", plan=None, remat=None, **kwargs):
    """Wrap a train step ``function`` (also usable as a decorator). The
    ``models`` are put in train mode when the wrapper is built; each call
    runs ``function`` eagerly. ``input_spec`` and ``donate_state`` are
    accepted and have nothing to do; bucketing, mesh plans,
    rematerialization and loss scalers are not ported and raise."""
    for name, value in (("bucket", bucket or buckets), ("plan", plan),
                        ("remat", remat), ("scalers", scalers)):
        if value:
            raise NotImplementedError(f"jit.to_static({name}=...) is not "
                                      f"ported yet")
    if kwargs:
        raise TypeError(f"jit.to_static: unexpected arguments "
                        f"{sorted(kwargs)}")

    def wrap(fn):
        for m in models or ():
            m.train()

        @functools.wraps(fn)
        def step(*args, **kw):
            return fn(*args, **kw)

        return step

    return wrap if function is None else wrap(function)
