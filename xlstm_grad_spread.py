#!/usr/bin/env python3
"""How far float32 rounding alone moves the reduced xlstm's gradients, on the CPU.

Run from the root of a checkout:

    python3 xlstm_grad_spread.py [--seeds 63 64 65] [--seqs 128 256 1024] [--perturb 1e-7]

For each seed and sequence length it takes the port's loss and grads of the
reduced xlstm-350m in float32 (B = 2, ``make_dataset``'s batch, the params
``init_model`` draws from the seed), then again from the params scaled by
1 + perturb x N(0, 1), and prints one JSON line: the largest rel-L2 of a
gradient leaf between the two runs and its leaf, and how many cells of the
sLSTM's n_t lie within 1e-4 of 1, where the gradient of max(n_t, 1) jumps.
``chip_smoke.py`` gates the card against the CPU at the lengths where this
spread is far below its tolerance (``XLSTM_CARD_VS_CPU_SEQ``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.kernels import slstm_scan as kscan  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.train import value_and_grad  # noqa: E402
from repro_torch.tree import flatten, tree_map  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, nargs="+", default=[63, 64, 65])
    ap.add_argument("--seqs", type=int, nargs="+", default=[128, 256, 1024])
    ap.add_argument("--perturb", type=float, default=1e-7)
    args = ap.parse_args()
    cfg = reduced(get_config("xlstm-350m"))
    loss_fn = lambda q, b: model_lib.loss_fn(q, cfg, b)  # noqa: E731
    planes = []
    save_plain = kscan.slstm_scan_save_plain

    def keep_planes(*a):  # the saved planes of the unperturbed run
        out = save_plain(*a)
        planes.append(out[4])
        return out

    for seed in args.seeds:
        params = model_lib.init_model(cfg, seed, device="cpu")
        for seq in args.seqs:
            batch = {k: torch.from_numpy(v) for k, v in make_dataset(cfg, seq, 2, seed).batch_at(0).items()}
            planes.clear()
            kscan.slstm_scan_save_plain = keep_planes
            try:
                _, grads = value_and_grad(loss_fn, params, batch)
            finally:
                kscan.slstm_scan_save_plain = save_plain
            gen = torch.Generator().manual_seed(seed)
            moved = tree_map(lambda t: t * (1 + args.perturb * torch.randn(t.shape, generator=gen)), params)
            _, moved_grads = value_and_grad(loss_fn, moved, batch)
            g, m = flatten(grads), flatten(moved_grads)
            spread = {k: float((m[k] - g[k]).norm() / g[k].norm()) for k in g}
            n = torch.cat([p[kscan.SAVED_PLANES.index("n")].flatten() for p in planes])
            print(json.dumps(dict(
                seed=seed, seq=seq, perturb=args.perturb, grad_rel_l2_max=max(spread.values()),
                worst_leaf=max(spread, key=spread.get), n_within_1e4_of_1=int(((n - 1).abs() < 1e-4).sum()),
            )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
