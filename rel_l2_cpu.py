#!/usr/bin/env python3
"""Project an ideal chip's logits distance from the plain-matmul model on the
CPU, at full width and a cut depth.

Run from the root of a checkout, e.g.::

    python3 rel_l2_cpu.py gemma2-9b --layers 2 4 8 --vocab 32768

For each depth it builds the config cut to that many layers (whole repeats of
its block pattern) and, if ``--vocab`` is given, to that vocabulary; draws
random weights from ``--seed``; programs an ideal chip; and prints the rel-L2
of the chip's logits against the plain-matmul model's on one 16-token prompt
(the measure ``chip_smoke.py`` gates).  For a model with MoE layers it also
prints ``forced_rel_l2``: the chip's logits against the plain-matmul model
routed as the chip routed (each MoE layer handed the chip's top-k ids, gates
and probabilities), the 16-bit datapath's error without routing flips.  A
hybrid's period is cut with ``--positions`` (its first P block positions,
once) and an MoE to one rank's experts with ``--share R/N``, e.g.::

    python3 rel_l2_cpu.py jamba-v0.1-52b --positions 2 4 --share 0/16 --vocab 4096

A model with an embedding front end (musicgen-large, pixtral-12b) is fed
seeded N(0, 1) frames in place of tokens and run as ``chip_smoke.py``
serves it: ``--slots`` prompts of ``--frames`` frames, each prefilled alone
into its slot of a pool cache, then ``--steps`` decode steps of the pool,
each fed the next frame; the rel-L2 is taken over the prefills' last
positions and every step's logits (``1 + steps`` positions a slot), e.g.::

    python3 rel_l2_cpu.py musicgen-large --layers 2 4 8 16

The fast kernel's function is exact
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

from chip_smoke import frame_logits  # noqa: E402  (the serving chip_smoke.py holds)

from repro_torch.configs import StageSpec, get_config  # noqa: E402
from repro_torch.device import programmed as tprog  # noqa: E402
from repro_torch.kernels import crossbar_vmm as kvmm  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.moe import ExpertShare  # noqa: E402
from repro_torch.models.layers import CrossbarMode, crossbar_mode  # noqa: E402


def exact_fast_vmm(x_codes, w_codes, spec, adc_cfg=None, fast=True):
    """The fast datapath's output codes from one float64 matmul."""
    acc = torch.matmul(x_codes.double(), (w_codes.long() + spec.weight_bias).double()).round().long()
    if spec.signed_weights:
        acc = acc - spec.weight_bias * x_codes.long().sum(-1, keepdim=True)
    lo, hi = spec.out_range
    return torch.clamp((acc + (1 << (spec.drop_lsb - 1))) >> spec.drop_lsb, lo, hi).to(torch.int32)


def cut_config(arch: str, layers: int, positions: int, vocab: int):
    """``arch`` cut to ``layers`` (whole repeats of its block pattern) or, if
    ``positions``, to its pattern's first ``positions`` blocks once."""
    cfg = get_config(arch)
    spec = cfg.stages[0]
    if positions:
        stage = StageSpec(kinds=spec.kinds[:positions], repeats=1, moe=spec.moe[:positions])
    else:
        stage = StageSpec(kinds=spec.kinds, repeats=layers // len(spec.kinds), moe=spec.moe)
    return dataclasses.replace(
        cfg, n_layers=stage.n_layers, vocab_size=vocab or cfg.vocab_size, stages=(stage,),
    )


def rel_l2(cfg, share: ExpertShare, seed: int, slots: int = 4, frames: int = 32, steps: int = 16) -> dict:
    """The chip's logits against the plain-matmul model's: ``rel_l2`` and,
    where the model routes, ``forced_rel_l2``."""
    params = model_lib.init_model(cfg, seed=seed, device="cpu", share=share)
    chip = tprog.program_model(params, tie_lm_head=cfg.tie_embeddings and cfg.frontend == "token", device="cpu")
    if cfg.frontend == "embed":
        gen = torch.Generator().manual_seed(seed + 7)
        x = torch.randn((slots, frames + steps, cfg.d_model), generator=gen)
        with crossbar_mode(CrossbarMode(enabled=True, strict=True, programmed=chip)), chip.bind():
            xbar = frame_logits(params, cfg, x, steps)[0]
        digital = frame_logits(params, cfg, x, steps)[0]
        return {"rel_l2": float((xbar - digital).norm() / digital.norm())}
    tok = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, size=(1, 16)))
    routes, real = [], moe_mod.route_from_logits

    def record(logits, cfg_, dtype):
        routes.append(real(logits, cfg_, dtype))
        return routes[-1]

    out = {}
    moe_mod.route_from_logits = record
    try:
        with moe_mod.expert_share(share):
            with crossbar_mode(CrossbarMode(enabled=True, strict=True, programmed=chip)), chip.bind():
                xbar = model_lib.forward(params, cfg, tok).float()
            moe_mod.route_from_logits = real
            digital = model_lib.forward(params, cfg, tok).float()
            out["rel_l2"] = float((xbar - digital).norm() / digital.norm())
            if routes:
                replay = iter(routes)
                moe_mod.route_from_logits = lambda logits, cfg_, dtype: next(replay)
                forced = model_lib.forward(params, cfg, tok).float()
                assert next(replay, None) is None, "the plain forward routed fewer times than the chip's"
                out["forced_rel_l2"] = float((xbar - forced).norm() / forced.norm())
    finally:
        moe_mod.route_from_logits = real
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("arch")
    ap.add_argument("--layers", type=int, nargs="+", default=[2])
    ap.add_argument("--positions", type=int, nargs="+", default=None,
                    help="cut the block pattern to its first P positions, once (in place of --layers)")
    ap.add_argument("--share", default="0/1", help="R/N: rank R's experts of an N-way expert-parallel deployment")
    ap.add_argument("--vocab", type=int, default=0, help="cut the vocabulary (0: the config's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=4, help="embedding front end: prompts, one a slot")
    ap.add_argument("--frames", type=int, default=32, help="embedding front end: frames a prompt")
    ap.add_argument("--steps", type=int, default=16, help="embedding front end: decode steps")
    args = ap.parse_args()
    kvmm.crossbar_vmm_plain = exact_fast_vmm  # the CPU wrapper's plain version
    rank, ranks = (int(v) for v in args.share.split("/"))
    share = ExpertShare(rank=rank, ranks=ranks)
    cuts = [(0, p) for p in args.positions] if args.positions else [(n, 0) for n in args.layers]
    for layers, positions in cuts:
        cfg = cut_config(args.arch, layers, positions, args.vocab)
        out = rel_l2(cfg, share, args.seed, args.slots, args.frames, args.steps)
        readings = " ".join(f"{k}={v:.4f}" for k, v in out.items())
        print(f"{args.arch} layers={cfg.n_layers} kinds={','.join(cfg.stages[0].kinds)} share={args.share} "
              f"vocab={args.vocab or 'full'} {readings}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
