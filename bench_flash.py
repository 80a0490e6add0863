"""Time the flash-attention backward kernels of one checkout on the card.

    python3 bench_flash.py [--tree DIR] [--label NAME] [--head-dims 64]
        [--out PATH]

It imports ``paddle_tpu_torch`` from ``--tree`` (default: the checkout
that holds this file, never ``jax`` or ``paddle_tpu``) and the timing
helpers of this checkout's ``chip_smoke.py`` (CUDA-graph device time,
inputs rotating over more than the L2 cache, the byte and operation
bound), so that two checkouts are timed by the same code. To compare two
trees on one card, run it once a tree in turns in one call (parent,
change, change, parent).

Cases, each on BERT's layout (head-split views of a fused QKV
projection, dO in (B, S, H, D) memory order), with a key padding mask of
real lengths 16..S: the float32 backward at (64, 12, 128, D) for each D
of ``--head-dims`` (64 alone by default; other head dims run padded,
which only a checkout with padding takes), float32 causal at (4, 12,
512, 64) without a mask, and bf16 at (64, 12, 128, 64) with dropout 0.1.
Each prints one JSON line prefixed by the label: the wrapper's device
time (``ms``: dQ, dK/dV and their glue), each kernel's alone at head dims
64 and 128 (``dq_ms``; ``dkv_ms``, from the delta a dQ launch wrote),
the backward of ``scaled_dot_product_attention`` on the same inputs
(``library_ms``: forward and backward minus forward), both kernels'
bounds, and the largest error against the plain backward. The first
line names the card and its power limit. It needs a CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ITERS = 50


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def backward_case(torch, C, FA, dtype, b, h, s, d, mask_kind, causal,
                  dropout_p, gen):
    dt = getattr(torch, dtype)
    es = torch.empty((), dtype=dt).element_size()
    seed = (7, 11)
    kw = dict(causal=causal, dropout_p=dropout_p, seed=seed)
    sets = C.flash_sets(torch, dtype, b, h, s, d, mask_kind, gen,
                        C.n_sets(4 * b * h * 2 * s * d * es))
    full = [st[:4] + FA.flash_attention_fwd(*st[:4], **kw) + (st[4],)
            for st in sets]
    got = FA.flash_attention_bwd(*full[0], **kw)
    ref = FA.flash_attention_bwd_plain(*full[0], **kw)
    rec = dict(dtype=dtype, shape=[b, h, s, d], mask=mask_kind,
               causal=causal, dropout_p=dropout_p,
               max_scaled_err=max(C.scaled_err(a, r)
                                  for a, r in zip(got, ref)),
               ms=C.graph_ms(torch, lambda *a: FA.flash_attention_bwd(*a, **kw),
                             full, ITERS))
    if d in FA.HEAD_DIMS:
        launchers = [(FA._bwd_setup(q, k, v, FA._canon_mask(mask, b, h, s, s),
                                    out, m, l, do, causal, None, dropout_p,
                                    seed)[3],)
                     for q, k, v, mask, out, m, l, do in full]
        rec["dq_ms"] = C.graph_ms(torch, lambda L: L(FA.BWD_DQ), launchers,
                                  ITERS)
        for (L,) in launchers:
            L(FA.BWD_DQ)
        rec["dkv_ms"] = C.graph_ms(torch, lambda L: L(FA.BWD_DKV),
                                   launchers, ITERS)
    F = torch.nn.functional
    lib_sets = [tuple(t.detach().requires_grad_() for t in (q, k, v)) +
                (None if mask is None else mask.to(dt), do)
                for q, k, v, mask, do in sets]

    def library_fwd(q, k, v, mask, do):
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal, dropout_p=dropout_p)

    with torch.no_grad():
        fwd_ms = C.graph_ms(torch, library_fwd, lib_sets, ITERS)
    rec["library_ms"] = C.graph_ms(
        torch, lambda q, k, v, mask, do: torch.autograd.grad(
            library_fwd(q, k, v, mask, do), (q, k, v), do),
        lib_sets, ITERS) - fwd_ms
    pairs = C.causal_pairs(s, s) if causal else s * s
    mask_bytes = 0 if sets[0][3] is None else sets[0][3].numel() * 4
    rd = 4 * b * h * s * d * es + 3 * b * h * s * 4 + mask_bytes
    rate, split = ("bfloat16", 1) if dtype == "bfloat16" else ("tfloat32", 3)
    rec["bound_dq_ms"] = C.bound(rd + 2 * b * h * s * d * es, split * (
        6 * b * h * pairs * d + 2 * b * h * s * d), rate)[0]
    rec["bound_dkv_ms"] = C.bound(rd + 2 * b * h * s * d * es,
                                  split * 8 * b * h * pairs * d, rate)[0]
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT),
                    help="the checkout whose paddle_tpu_torch is timed")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--head-dims", default="64",
                    help="comma-separated head dims of the f32 S=128 case")
    ap.add_argument("--out", help="also append the records to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("bench_flash: no CUDA card", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import flash_attention as FA
    assert Path(FA.__file__).resolve().is_relative_to(
        Path(args.tree).resolve()), FA.__file__
    C = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(C.nvidia_smi(), flush=True)
    kernels.build("flash_attention_fwd", "flash_attention_bwd_dq")
    gen = torch.Generator(device="cuda").manual_seed(0)
    C.warm_card(torch)
    cases = [("float32", 64, 12, 128, int(d), "key", False, 0.0)
             for d in args.head_dims.split(",")]
    cases += [("float32", 4, 12, 512, 64, None, True, 0.0),
              ("bfloat16", 64, 12, 128, 64, "key", False, 0.1)]
    records = []
    for case in cases:
        rec = dict(label=args.label, **backward_case(torch, C, FA, *case,
                                                      gen))
        records.append(rec)
        print(args.label, json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
