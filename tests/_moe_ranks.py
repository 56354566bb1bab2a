"""Rank processes of the port's MoE mesh tests (``test_torch_moe_ranks.py``):
importable without JAX, so a spawned rank starts with torch alone."""
import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.checkpoint import restore_programmed
from repro_torch.convert import params_from_numpy
from repro_torch.device import programmed as tprog
from repro_torch.kernels import crossbar_vmm as kvmm
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.train.compression import ef_int8_psum


def load_params(path: str):
    """The flat ``{a/b/c: array}`` npz of a params tree, nested, as tensors."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return params_from_numpy(tree, device="cpu")


def _mode(chip):
    return TL.CrossbarMode(enabled=True, programmed=chip, strict=True)


def moe_layer(params, chip, cfg, mesh, x):
    """Layer 0's MoE FFN of stage 0 served from ``chip`` (its layer-0 views
    bound as the stage binds them), under ``mesh`` when given: (output, K1
    calls, artifacts consumed, misses)."""
    kvmm.reset_counters()
    tprog.reset_consumed_artifact_names()
    TL.reset_crossbar_misses()
    ffn = {k: v[0] for k, v in params["stage0"]["b0"]["ffn"].items()}
    overrides = TL.layout_overrides(cfg) if mesh is not None else None
    with TL.crossbar_mode(_mode(chip)), TL.use_mesh(mesh, overrides), \
            tprog._push_bind_map(chip.stage_layer_maps("stage0")[0]), tprog.name_scope("stage0"), \
            tprog.name_scope("b0"), tprog.name_scope("ffn"):
        y = TMoE.moe_ffn(ffn, x, cfg)
    return (y.numpy(), sum(kvmm.PLAIN_CALLS.values()), sorted(tprog.consumed_artifact_names()),
            list(TL.crossbar_misses()))


@contextlib.contextmanager
def counting_drops(dropped: list):
    """Append to ``dropped`` the assignments each ``slot_tables`` call of
    the MoE layer drops past capacity (not those left to another rank's
    experts)."""
    real = TMoE.slot_tables

    def spy(top_idx, gates, n_local, capacity, lo=0):
        out = real(top_idx, gates, n_local, capacity, lo)
        e = top_idx.to(torch.int64) - lo
        foreign = int(((e < 0) | (e >= n_local)).sum())
        dropped.append(int((out[2] == n_local * capacity).sum()) - foreign)
        return out

    TMoE.slot_tables = spy
    try:
        yield
    finally:
        TMoE.slot_tables = real


def slice_chip(chip, specs, mesh):
    """The rank's slices of a whole chip: ``local_artifact`` of every
    artifact ``specs`` names (by the weight's spec), the rest as held."""
    def carry(node, path):
        if isinstance(node, tprog.ProgrammedLinear):
            spec = specs.get("/".join(path))
            return node if spec is None else tprog.local_artifact(node, spec, mesh.shape, mesh.coords)
        if isinstance(node, dict):
            return {k: carry(v, path + (str(k),)) for k, v in node.items()}
        return node

    return tprog.ProgrammedModel(carry(chip.artifacts, ()))


def forward(params, chip, cfg, mesh, tokens):
    overrides = TL.layout_overrides(cfg) if mesh is not None else None
    with TL.crossbar_mode(_mode(chip)), TL.use_mesh(mesh, overrides):
        return TM.forward(params, cfg, tokens).numpy()


def _collectives(mesh, rank):
    """Each collective on a rank-valued (4, 2) tensor, for the parent to
    hold against numpy."""
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2) + 100 * rank
    return {
        "psum": mesh.psum(x, "model").numpy(),
        "all_to_all": mesh.all_to_all(x, "data").numpy(),
        "psum_scatter": mesh.psum_scatter(x, "model", 0).numpy(),
        "all_gather": mesh.all_gather(x, ("data", "model"), 1).numpy(),
    }


def capped_bodies(params, chip14, chip22, cfg, mesh14, mesh22, x):
    """The three bodies at top 1 under ``cfg``'s capacity: {body: (output,
    assignments this rank's dispatch dropped)}."""
    etp = dataclasses.replace(cfg, layout="expert_tp")
    runs = (("ep", cfg, chip14, mesh14), ("alltoall", dataclasses.replace(cfg, moe_dispatch="alltoall"), chip14, mesh14),
            ("expert_tp", etp, chip22, mesh22))
    out = {}
    for body, c, chip, mesh in runs:
        dropped = []
        with counting_drops(dropped):
            y = moe_layer(TMoE.rank_params(params, c, mesh), chip, c, mesh, x)[0]
        out[body] = (y, sum(dropped))
    return out


def rank_moe(rank: int, workdir: str, cfg, capped):
    """One rank of the tiny MoE LM on a (1, 4) and a (2, 2) mesh: the
    expert-parallel and all-to-all bodies from the slices the store records,
    expert-TP from the same store laid out anew, at top 1 and top 2, and at
    top 1 under ``capped`` (a config whose capacity drops assignments of
    the input ``x_cap``); the whole forward under EP; expert-TP from the
    whole chip, sliced once by the rank."""
    torch.set_num_threads(1)  # four ranks share the host's cores
    mesh14 = make_local_mesh(1, 4)
    mesh22 = make_local_mesh(2, 2)
    params = load_params(f"{workdir}/params.npz")
    with np.load(f"{workdir}/inputs.npz") as z:
        x, tokens, x_cap = (torch.from_numpy(z[k]) for k in ("x", "tokens", "x_cap"))
    store = f"{workdir}/store"
    out = {"coords": (mesh14.coords, mesh22.coords), "collectives": _collectives(mesh22, rank)}
    chip14 = restore_programmed(store, device="cpu", mesh=mesh14)
    etp = dataclasses.replace(cfg, layout="expert_tp")
    chip22 = restore_programmed(store, device="cpu", mesh=mesh22, specs=TMoE.param_specs(params, etp, mesh22))
    out["shapes14"] = {n: a.shape for n, a in chip14.by_name.items()}
    out["shapes22"] = {n: a.shape for n, a in chip22.by_name.items()}
    for k in (1, 2):
        ck = dataclasses.replace(cfg, moe_top_k=k)
        for body, c in (("ep", ck), ("alltoall", dataclasses.replace(ck, moe_dispatch="alltoall"))):
            out[f"{body}/{k}"] = moe_layer(TMoE.rank_params(params, c, mesh14), chip14, c, mesh14, x)
        c = dataclasses.replace(etp, moe_top_k=k)
        out[f"expert_tp/{k}"] = moe_layer(TMoE.rank_params(params, c, mesh22), chip22, c, mesh22, x)
    out["capped"] = capped_bodies(params, chip14, chip22, capped, mesh14, mesh22, x_cap)
    out["forward/ep"] = forward(TMoE.rank_params(params, cfg, mesh14), chip14, cfg, mesh14, tokens)
    whole = slice_chip(restore_programmed(store, device="cpu"), TMoE.param_specs(params, etp, mesh22), mesh22)
    out["expert_tp/1/whole_chip"] = moe_layer(TMoE.rank_params(params, etp, mesh22), whole, etp, mesh22, x)
    out["traffic"] = (mesh14.traffic, mesh22.traffic)
    return out


def rank_ef(rank: int, g: np.ndarray, steps: int):
    """``ef_int8_psum`` over an 8-rank "data" axis, rank ``r`` holding row
    ``g[r]``: one step from a zero residual, and the mean of ``steps``
    error-fed steps."""
    torch.set_num_threads(1)
    mesh = make_local_mesh()  # every rank on "data"
    x = torch.from_numpy(g[rank])
    one, _ = ef_int8_psum(x, torch.zeros_like(x), mesh, "data")
    err, acc = torch.zeros_like(x), torch.zeros_like(x)
    for _ in range(steps):
        out, err = ef_int8_psum(x, err, mesh, "data")
        acc = acc + out
    return one.numpy(), (acc / steps).numpy()
