"""Time the layer-norm kernels of one checkout on the card.

    python3 paddle_tpu_torch/tools/bench_layer_norm.py [--tree DIR]
        [--label NAME] [--out PATH]

Run it by its path, not with ``-m``: it imports ``paddle_tpu_torch`` from
``--tree`` (default: the checkout that holds this file; never ``jax`` or
``paddle_tpu``) and the cases and timing of this checkout's
``chip_smoke.py`` (``layer_norm_case`` and ``layer_norm_bwd_case``:
CUDA-graph device time, inputs rotating over more than the L2 cache, the
byte bound), so that two checkouts are timed by the same code. To compare
two trees on one card, run it once a tree in turns in one call (parent,
change, change, parent).

Cases: the forward (#1) at (4096, 768) and (8192, 768) in float32 and in
bf16 (weight in x's dtype, as bf16 serving runs it), and the backward
(#2) at the same shapes in float32 and bf16 (weight float32, as the
training step runs it). Each prints one JSON line prefixed by the label:
the kernel's device time (``ms``), the plain version's (``plain_ms``),
the library call's (``library_ms``: PyTorch's own layer norm, forward or
backward, which ``chip_smoke.py`` names and the port never calls), the
bound (``bound_ms``) and the error against the plain version. The first line names the card and its
power limit. It needs a CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ITERS = 50
SHAPES = ((4096, 768), (8192, 768))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT),
                    help="the checkout whose paddle_tpu_torch is timed")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", help="also append the records to this file")
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        print("bench_layer_norm: no CUDA card", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import layer_norm as LN
    if not Path(LN.__file__).resolve().is_relative_to(tree):
        print(f"bench_layer_norm: imported {LN.__file__}, not {tree}'s "
              f"port; run this file by its path", file=sys.stderr)
        return 2
    C = _chip_smoke()
    C.emit = lambda rec: None       # the cases' own records: printed below
    print(C.nvidia_smi(), flush=True)
    kernels.build("layer_norm_fwd", "layer_norm_bwd")
    gen = torch.Generator(device="cuda").manual_seed(0)
    C.warm_card(torch)
    records = []
    for case in (C.layer_norm_case, C.layer_norm_bwd_case):
        for n, d in SHAPES:
            for dtype in ("float32", "bfloat16"):
                rec = dict(label=args.label, **case(torch, LN, dtype, n, d,
                                                    ITERS, gen))
                records.append(rec)
                print(args.label, json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
