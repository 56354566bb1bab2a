"""Rank processes of the port's mesh-serving tests
(``test_torch_serve_mesh.py``): importable without JAX, so a spawned rank
starts with torch alone."""
import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.device import DeviceConfig
from repro_torch.device import programmed as tprog
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.layers import CrossbarMode
from repro_torch.models.moe import ExpertShare, rank_params
from repro_torch.serving import ServingEngine

# the reference's noisy chip of its mesh-serving test
NOISY = DeviceConfig(sigma=0.05, p_stuck_on=1e-3, p_stuck_off=1e-3, write_verify_iters=2)


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


def serve(eng, prompts, max_new):
    """The engine's tokens for ``prompts`` and the active slots' logits at
    every tick."""
    ticks = []
    real = eng.runner.sample

    def sample(logits):
        ticks.append(np.array(logits[[i for i, s in enumerate(eng.slots) if s is not None]]))
        return real(logits)

    eng.runner.sample = sample
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    done = {r.rid: r for r in eng.run_until_done()}
    del eng.runner.sample
    return [done[i].generated for i in rids], ticks


def _refusals(cfg, params, mesh, eng, store) -> dict:
    """Which lifecycle verbs and arguments the mesh engine refuses, by the
    exception each raised."""
    out = {}
    for verb in ("compensate", "health_check", "refresh"):
        with pytest.raises(NotImplementedError, match="under a mesh") as e:
            getattr(eng, verb)()
        out[verb] = str(e.value)
    with pytest.raises(NotImplementedError, match="under a mesh"):
        eng.save_artifacts("unused")
    with pytest.raises(ValueError, match="ExpertShare"):
        ServingEngine(cfg, params, max_batch=1, max_seq=16, mesh=mesh, share=ExpertShare(0, 4), device="cpu")
    with pytest.raises(ValueError, match="whole params"):
        ServingEngine(cfg, rank_params(params, cfg, mesh), max_batch=1, max_seq=16, mesh=mesh, device="cpu",
                      crossbar=CrossbarMode(enabled=True))
    with pytest.raises(ValueError, match="rank's copy"):
        ServingEngine(cfg, params, max_batch=1, max_seq=16, mesh=mesh, device="cpu",
                      crossbar=CrossbarMode(enabled=True), restore_artifacts=store)
    return out


def rank_ep(rank: int, workdir: str, cfg, prompts, max_new):
    """One rank on a (1, 4) mesh: a digital mesh engine, a mesh engine that
    programs the noisy chip from the whole tree, one that restores this
    rank's slices from the one-device engine's store (given this rank's copy
    of the params), and that engine after a hot swap from the same store;
    the slices of both chip engines, and the refusals."""
    torch.set_num_threads(1)  # four ranks share the host's cores
    mesh = make_local_mesh(1, 4)
    params = load_params(f"{workdir}/params.npz")
    store = f"{workdir}/store"
    noisy = CrossbarMode(enabled=True, strict=True, device=NOISY)
    programs = ServingEngine(cfg, params, max_batch=2, max_seq=32, crossbar=noisy, mesh=mesh, device="cpu")
    out = {"programs": serve(programs, prompts, max_new), "coords": mesh.coords,
           "digital": serve(ServingEngine(cfg, params, max_batch=2, max_seq=32, mesh=mesh, device="cpu"),
                            prompts, max_new)}
    restores = ServingEngine(
        cfg, rank_params(params, cfg, mesh), max_batch=2, max_seq=32, mesh=mesh, device="cpu",
        crossbar=CrossbarMode(enabled=True, strict=True), restore_artifacts=store,
    )
    a, b = programs.programmed.by_name, restores.programmed.by_name
    out["slices_equal"] = set(a) == set(b) and all(tprog.artifacts_equal(a[n], b[n]) for n in a)
    out["bank_shape"] = tuple(b["stage1/b0/ffn/wi"].shape)
    out["restores"] = serve(restores, prompts, max_new)
    restores.hot_swap(store)
    out["hot_swapped"] = serve(restores, prompts, max_new)
    out["graphs"] = (restores.runner.decode_graph, dict(restores.runner.prefill_graphs))
    out["refused"] = _refusals(cfg, params, mesh, restores, store)
    return out


def rank_expert_tp(rank: int, workdir: str, cfg, prompts, max_new):
    """One rank on a (2, 2) mesh under the expert-TP layout, digital: this
    rank's copy of the whole tree, the engine's tokens and tick logits."""
    torch.set_num_threads(1)
    mesh = make_local_mesh(2, 2)
    params = load_params(f"{workdir}/params.npz")
    eng = ServingEngine(cfg, params, max_batch=2, max_seq=32, mesh=mesh, device="cpu")
    return {"served": serve(eng, prompts, max_new), "coords": mesh.coords,
            "bank_shape": tuple(eng.params["stage1"]["b0"]["ffn"]["wi"].shape), "traffic": mesh.traffic}
