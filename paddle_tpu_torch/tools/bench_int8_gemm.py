"""Time the int8 GEMM of one checkout on the card.

    python3 paddle_tpu_torch/tools/bench_int8_gemm.py [--tree DIR]
        [--label NAME] [--out PATH]

Run it by its path, not with ``-m``: it imports ``paddle_tpu_torch`` from
``--tree`` (default: the checkout that holds this file; never ``jax`` or
``paddle_tpu``) and the timing of this checkout's ``chip_smoke.py``
(CUDA-graph device time, inputs rotating over more than the L2 cache, the
bound at the card's int8 rate and memory rate), so that two checkouts are
timed by the same code. To compare two trees on one card, run it once a
tree in turns in one call (parent, change, change, parent).

Cases: ``chip_smoke.py``'s ``INT8_GEMM_CASES`` of at least 8 rows (BERT-
base's four products of a served batch and its pooler, ``bench_int8``'s
512 x 4,096 x 4,096, three of ResNet-50's at batch 8), f32 out with an
f32 bias. Each prints one JSON line prefixed by the label: the device
time (``ms``), the bound (``bound_ms``, ``bound_by``) and the route the
tree's wrapper picks (``route``, where it has ``gemm_route``). The first
line names the card and its power limit. It needs a CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ITERS = 50


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
        print("bench_int8_gemm: no CUDA card", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import int8_gemm as G
    if not Path(G.__file__).resolve().is_relative_to(tree):
        print(f"bench_int8_gemm: imported {G.__file__}, not {tree}'s "
              f"port; run this file by its path", file=sys.stderr)
        return 2
    C = _chip_smoke()
    print(C.nvidia_smi(), flush=True)
    kernels.build("int8_gemm")
    gen = torch.Generator(device="cuda").manual_seed(0)
    C.warm_card(torch)
    records = []
    for case, m, k, n in C.INT8_GEMM_CASES:
        if m < 8:
            continue
        sets = []
        for _ in range(C.n_sets(m * k + n * k + 4 * m * n)):
            x = torch.randn(m, k, device="cuda", generator=gen)
            asc = x.abs().amax() * 0.9
            sets.append((G.int8_quantize(x, asc),
                         torch.randint(-127, 128, (n, k), device="cuda",
                                       generator=gen, dtype=torch.int8),
                         torch.rand(n, device="cuda", generator=gen) * 1e-3
                         + 1e-4, asc,
                         torch.randn(n, device="cuda", generator=gen)))
        rec = dict(label=args.label, case=case, shape=[m, k, n],
                   ms=C.graph_ms(torch, lambda q, b, w, a, bi: G.int8_gemm(
                       q, b, w, a, bi), sets, ITERS))
        nbytes = m * k + n * k + 8 * n + 4 + 4 * m * n
        rec["bound_ms"], rec["bound_by"] = C.bound(nbytes, 2 * m * k * n,
                                                   "int8")
        if hasattr(G, "route_of"):
            rec["route"] = G.route_name(G.route_of(sets[0][0], sets[0][1],
                                                   G._sm_count(sets[0][0])))
        records.append(rec)
        print(args.label, json.dumps(rec), flush=True)
        del sets
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
