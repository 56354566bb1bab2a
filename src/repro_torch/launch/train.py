"""Training launcher (counterpart of ``repro.launch.train``).

Runs real training (synthetic or memmap data) on one device:

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

(``--reduced`` for a smoke-size config, ``--device cpu`` without a card.)
Re-running the same command resumes from the newest checkpoint
(deterministic data => identical continuation); NaN steps are skipped;
straggler steps are flagged.  Data- and model-parallel training are not
ported: ``--model-parallel`` above 1 is refused, and ``cfg.fsdp`` (a layout
over devices) changes nothing on one device, as in the reference on a
one-device mesh.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config, reduced
from repro_torch.data import make_dataset
from repro_torch.models import model as model_lib
from repro_torch.optim import cosine_with_warmup, make_optimizer
from repro_torch.train import TrainLoop, make_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="smoke-size config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--data", default=None, help="memmap token file (int32)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.model_parallel > 1:
        ap.error(
            "--model-parallel > 1: sharded training is not ported yet "
            "(ROADMAP Queue 1: training over a mesh; the port's sharding serves MoE ranks only); "
            "this launcher trains on one device"
        )

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    device = model_lib.require_device(args.device)
    print(f"[train] arch={cfg.name} params={cfg.param_count()/1e6:.1f}M device={device}", flush=True)

    params = model_lib.init_model(cfg, seed=args.seed, device=device)
    opt = make_optimizer(cfg.optimizer, cosine_with_warmup(args.lr, args.steps // 10 + 1, args.steps))
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches)

    ds = make_dataset(cfg, args.seq, args.batch, seed=args.seed, path=args.data)
    loop = TrainLoop(cfg, step_fn, ds, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, log_every=10)
    params, opt_state, start = loop.maybe_resume(params, opt_state)
    loop.run(params, opt_state, args.steps, start_step=start)
    print("[train] done", flush=True)


if __name__ == "__main__":
    main()
