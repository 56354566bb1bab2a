"""Serving launcher (counterpart of ``repro.launch.serve``): batched requests
through the serving engine on one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --reduced --requests 8 --max-new 16 [--crossbar]

(``--device cpu`` without a card.)  ``--crossbar`` routes every projection
through the Newton bit-sliced crossbar datapath, programmed per call (the
fast kernel on the card, its plain version on the CPU), and reports the
analytic Newton-vs-ISAAC energy estimate for the served tokens.  An
architecture with an embedding front end (musicgen-large, pixtral-12b) is
refused: its requests are embeddings, not token prompts, and the engine
refuses them (the reference's launcher fails on them inside the engine).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ALL_ARCHS, get_config, reduced
from repro_torch.models import model as model_lib
from repro_torch.models.layers import CrossbarMode, crossbar_mode
from repro_torch.serving import ServingEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True, choices=ALL_ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--crossbar", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if cfg.frontend != "token":
        ap.error(
            f"--arch {args.arch}: its {cfg.frontend!r} front end takes precomputed embeddings, and the "
            "serving engine serves token prompts (models.model.prefill / decode_step serve it)"
        )
    if args.reduced:
        cfg = reduced(cfg)
    device = model_lib.require_device(args.device)
    params = model_lib.init_model(cfg, seed=args.seed, device=device)
    engine = ServingEngine(
        cfg, params, max_batch=args.max_batch, max_seq=args.max_seq,
        temperature=args.temperature, seed=args.seed, device=device,
    )
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        n = int(rng.integers(4, 48))
        engine.submit(rng.integers(0, cfg.vocab_size, size=n), max_new_tokens=args.max_new)

    mode = CrossbarMode(enabled=args.crossbar)
    t0 = time.perf_counter()
    with crossbar_mode(mode):
        reqs = engine.run_until_done()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.generated) for r in reqs)
    print(f"[serve] {len(reqs)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s){' [crossbar datapath]' if args.crossbar else ''}", flush=True)
    for r in reqs[:4]:
        print(f"  req{r.rid}: {r.generated[:12]}", flush=True)

    if args.crossbar:
        from repro_torch.core import arch as hw, energy as en, workloads as wl

        net = wl.lm_workload(cfg)
        newton = en.evaluate(net, hw.NEWTON_CHIP, policy="newton", strassen=True)
        isaac = en.evaluate(net, hw.ISAAC_CHIP, policy="isaac")
        print(f"[newton] serving energy estimate: {newton.energy_per_sample_j*1e6:.1f} uJ/token "
              f"(ISAAC baseline {isaac.energy_per_sample_j*1e6:.1f} uJ/token, "
              f"{isaac.energy_per_sample_j/newton.energy_per_sample_j:.2f}x)", flush=True)


if __name__ == "__main__":
    main()
