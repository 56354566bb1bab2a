#!/usr/bin/env python3
"""Project an ideal chip's logits distance from the plain-matmul model on the
CPU, at full width and a cut depth.

Run from the root of a checkout, e.g.::

    python3 rel_l2_cpu.py gemma2-9b --layers 2 4 8 --vocab 32768

For each depth it builds the config cut to that many layers (whole repeats of
its block pattern) and, if ``--vocab`` is given, to that vocabulary; draws
random weights from ``--seed``; programs an ideal chip; and prints the rel-L2
of the chip's logits against the plain-matmul model's on one 16-token prompt
(the measure ``chip_smoke.py`` gates).  The fast kernel's function is exact
integer arithmetic, so its plain version is swapped for one float64 matmul of
the codes (exact below 2**53), requantized as the kernel does: the same
codes, in seconds instead of hours.  Memory: about 12 GB at gemma2-9b's width
and 8 layers with a 32768-token vocabulary.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs import StageSpec, get_config  # noqa: E402
from repro_torch.device import programmed as tprog  # noqa: E402
from repro_torch.kernels import crossbar_vmm as kvmm  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models.layers import CrossbarMode, crossbar_mode  # noqa: E402


def exact_fast_vmm(x_codes, w_codes, spec, adc_cfg=None, fast=True):
    """The fast datapath's output codes from one float64 matmul."""
    acc = torch.matmul(x_codes.double(), (w_codes.long() + spec.weight_bias).double()).round().long()
    if spec.signed_weights:
        acc = acc - spec.weight_bias * x_codes.long().sum(-1, keepdim=True)
    lo, hi = spec.out_range
    return torch.clamp((acc + (1 << (spec.drop_lsb - 1))) >> spec.drop_lsb, lo, hi).to(torch.int32)


def rel_l2(arch: str, layers: int, vocab: int, seed: int) -> float:
    cfg = get_config(arch)
    spec = cfg.stages[0]
    cfg = dataclasses.replace(
        cfg, n_layers=layers, vocab_size=vocab or cfg.vocab_size,
        stages=(StageSpec(kinds=spec.kinds, repeats=layers // len(spec.kinds)),),
    )
    params = model_lib.init_model(cfg, seed=seed, device="cpu")
    chip = tprog.program_model(params, tie_lm_head=cfg.tie_embeddings, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, size=(1, 16)))
    with crossbar_mode(CrossbarMode(enabled=True, strict=True, programmed=chip)), chip.bind():
        xbar = model_lib.forward(params, cfg, tok).float()
    digital = model_lib.forward(params, cfg, tok).float()
    return float((xbar - digital).norm() / digital.norm())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("arch")
    ap.add_argument("--layers", type=int, nargs="+", default=[2])
    ap.add_argument("--vocab", type=int, default=0, help="cut the vocabulary (0: the config's)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    kvmm.crossbar_vmm_plain = exact_fast_vmm  # the CPU wrapper's plain version
    for layers in args.layers:
        print(f"{args.arch} layers={layers} vocab={args.vocab or 'full'} "
              f"rel_l2={rel_l2(args.arch, layers, args.vocab, args.seed):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
