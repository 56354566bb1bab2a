"""Training launcher (counterpart of ``repro.launch.train``).

Runs real training (synthetic or memmap data) on one device:

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

or over a ("data", "model") mesh of ``--ranks`` rank processes (gloo; the
default is one a card present, ``cuda:rank`` mod the cards; ranks that
share the one card exchange through its mailboxes, ``launch.mesh``),
``--model-parallel M`` of them a model group:

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --model-parallel 2 --ranks 4 --steps 200 --batch 8 --seq 128

The config's layout decides what the mesh does: ``tp`` splits heads, FFN
units and the vocabulary over "model" and the batch over "data";
``pure_dp`` (xlstm-350m) splits the batch over both.  An MoE config, or one
with ``cfg.fsdp``, is refused over a mesh.  ``--batch`` is the global
batch.  (``--reduced`` for a smoke-size config, ``--device cpu`` without a
card.)  Re-running the same command resumes from the newest checkpoint
(deterministic data => identical continuation; a checkpoint is the whole
tree, so a mesh run resumes a one-device one and the other way round); NaN
steps are skipped; straggler steps are flagged.
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data import make_dataset
from repro_torch.launch import sharding
from repro_torch.launch.mesh import make_local_mesh, run_ranks
from repro_torch.models import model as model_lib
from repro_torch.optim import cosine_with_warmup, make_optimizer
from repro_torch.train import TrainLoop, make_train_step

MESH_REFUSED = "ROADMAP.md Queue 1: MoE and FSDP training over a mesh"


def _train(args, cfg, device, mesh=None) -> None:
    opt = make_optimizer(cfg.optimizer, cosine_with_warmup(args.lr, args.steps // 10 + 1, args.steps))
    params = model_lib.init_model(cfg, seed=args.seed, device=device)
    specs = None
    if mesh is not None:
        specs = sharding.train_specs(cfg, params, cfg.optimizer, mesh)
        params = sharding.local_slice(params, specs["params"], mesh)
    opt_state = opt.init(params)
    step_fn = make_train_step(
        cfg, opt, microbatches=args.microbatches, mesh=mesh, specs=specs and specs["params"]
    )
    # a rank reads the whole global batch (a device of the reference's one
    # process); the mesh step takes its rows
    where = dict(process_index=0, process_count=1) if mesh is not None else {}
    ds = make_dataset(cfg, args.seq, args.batch, seed=args.seed, path=args.data, **where)
    loop = TrainLoop(cfg, step_fn, ds, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, log_every=10,
                     mesh=mesh, specs=specs)
    params, opt_state, start = loop.maybe_resume(params, opt_state)
    loop.run(params, opt_state, args.steps, start_step=start)


def _rank(rank: int, args, cfg, world: int) -> None:
    """One rank process: its card (or the CPU), the mesh, the loop."""
    if args.device == "cpu":
        device = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    else:
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    _train(args, cfg, device, make_local_mesh(world // args.model_parallel, args.model_parallel))


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
    ap.add_argument("--ranks", type=int, default=None,
                    help="rank processes (default: the cards present; 1 with --device cpu)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--data", default=None, help="memmap token file (int32)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, layout=cfg.layout)  # a pure_dp model stays pure_dp over a mesh
    device = model_lib.require_device(args.device)
    world = args.ranks or (torch.cuda.device_count() if device.type == "cuda" else 1)
    if world == 1 and args.model_parallel == 1:
        print(f"[train] arch={cfg.name} params={cfg.param_count()/1e6:.1f}M device={device}", flush=True)
        _train(args, cfg, device)
        print("[train] done", flush=True)
        return
    if cfg.moe_experts or cfg.fsdp:
        ap.error(f"{cfg.name} over a mesh: {'MoE' if cfg.moe_experts else 'FSDP'} training is not ported ({MESH_REFUSED})")
    if world % args.model_parallel:
        ap.error(f"--ranks {world} is no multiple of --model-parallel {args.model_parallel}")
    print(f"[train] arch={cfg.name} params={cfg.param_count()/1e6:.1f}M layout={cfg.layout} "
          f"mesh=(data {world // args.model_parallel}, model {args.model_parallel}) device={device}", flush=True)
    run_ranks(_rank, world, (args, cfg, world), timeout_s=24 * 3600.0)
    print("[train] done", flush=True)


if __name__ == "__main__":
    main()
