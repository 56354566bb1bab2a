#!/usr/bin/env python3
"""How far apart bf16 gradients land when the same sums are split over a
mesh, beside bf16's own distance from float32 (CPU only).

smollm-360m at full width, cut to ``--layers`` layers, bf16 params from a
seed: one step's gradients on one device in bf16 and in float32 (the same
params cast), and over a ``--mesh`` (data, model) mesh of spawned gloo ranks
in bf16 (``make_train_step(mesh=)``, gathered).  Prints each leaf's rel-L2:
one device's bf16 against its float32, the mesh's bf16 against that float32,
and the mesh's bf16 against one device's bf16.  ``chip_smoke.py``'s
``train_mesh`` holds the last to the larger of 1e-2 and twice the first,
leaf by leaf, beside its float32 gate: no split of a sum keeps one device's
bf16 roundings.

  PYTHONPATH=src python3 mesh_bf16_noise.py --layers 6 --mesh 2 2 --seq 64

(about 30 s on the CPU at 6 layers: one process and 4 ranks of one thread each).
"""
import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs import StageSpec, get_config  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, run_ranks  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.optim import Optimizer, constant, make_optimizer  # noqa: E402
from repro_torch.train import make_train_step, value_and_grad  # noqa: E402
from repro_torch.tree import flatten, tree_map  # noqa: E402

SEED = 64


def config(layers: int, dtype: str):
    cfg = get_config("smollm-360m")
    spec = cfg.stages[0]
    return dataclasses.replace(
        cfg, n_layers=layers, stages=(StageSpec(spec.kinds, layers, spec.moe),), param_dtype=dtype
    )


def batch(cfg, seq: int):
    ds = SyntheticLMDataset(cfg.vocab_size, seq, 4, seed=SEED, process_index=0, process_count=1)
    return {k: torch.from_numpy(v) for k, v in ds.batch_at(0).items()}


def rank_grads(rank, layers, seq, shape):
    """One rank's step; rank 0 returns the gathered bf16 gradients."""
    torch.set_num_threads(1)
    cfg = config(layers, "bfloat16")
    mesh = make_local_mesh(*shape)
    whole = model_lib.init_model(cfg, SEED, device="cpu")
    specs = sharding.train_specs(cfg, whole, "adamw", mesh)
    params = sharding.local_slice(whole, specs["params"], mesh)
    opt = make_optimizer("adamw", constant(1e-3))
    seen = {}

    def update(grads, state, p, step, ok=None, norm=None):
        seen.update(tree_map(torch.clone, grads))
        return opt.update(grads, state, p, step, ok=ok, norm=norm)

    step_fn = make_train_step(cfg, Optimizer(opt.init, update), mesh=mesh, specs=specs["params"])
    step_fn(params, opt.init(params), torch.tensor(0), batch(cfg, seq))
    whole_grads = sharding.gather(seen, specs["params"], mesh)
    return {k: v.float().numpy() for k, v in flatten(whole_grads).items()} if rank == 0 else None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--mesh", type=int, nargs=2, default=(2, 2), metavar=("DATA", "MODEL"))
    ap.add_argument("--seq", type=int, default=64)
    args = ap.parse_args()
    one = {}
    for dtype in ("bfloat16", "float32"):
        cfg = config(args.layers, dtype)
        params = model_lib.init_model(config(args.layers, "bfloat16"), SEED, device="cpu")
        params = tree_map(lambda t: t.to(getattr(torch, dtype)), params)
        _, g = value_and_grad(lambda q, b: model_lib.loss_fn(q, cfg, b), params, batch(cfg, args.seq))
        one[dtype] = {k: v.float().numpy() for k, v in flatten(g).items()}
    mesh = run_ranks(rank_grads, args.mesh[0] * args.mesh[1], (args.layers, args.seq, tuple(args.mesh)))[0]

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    print(f"smollm-360m, {args.layers} layers, B 4 x S {args.seq}, mesh {tuple(args.mesh)}: rel-L2 of each leaf")
    print(f"{'leaf':32s} {'1dev bf16 v f32':>16s} {'mesh bf16 v f32':>16s} {'mesh v 1dev bf16':>17s}")
    for k, f32 in one["float32"].items():
        print(f"{k:32s} {rel(one['bfloat16'][k], f32):16.3e} {rel(mesh[k], f32):16.3e} "
              f"{rel(mesh[k], one['bfloat16'][k]):17.3e}")


if __name__ == "__main__":
    main()
