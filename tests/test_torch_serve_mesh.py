"""PyTorch port, serving over a mesh (``ServingEngine(mesh=)``): the reduced
deepseek-v2 (float32, 8 experts, top 2) served by 4 spawned gloo ranks on the
CPU, one spawn a mesh.

On an ``ep_only`` (1, 4) mesh, the mirror of the reference's
``test_engine_mesh_serving_matches_single_device``: a one-device engine, a
mesh engine that programs the noisy chip and a mesh engine that restores
its slices from the one-device engine's store generate the same tokens, and
the restored slices equal the programmed ones; the lifecycle verbs the mesh
does not serve are refused.  The ranks' digital mesh engines serve the
tokens and tick logits of the JAX package's ``ServingEngine(mesh=)`` on the
same (1, 4) mesh of host devices (a subprocess).  On an ``expert_tp`` (2, 2) mesh, uncapped and
digital: every rank's tick logits within the reference's 5e-3 of one device,
and the same tokens on every rank.  Then the serving launcher."""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _serve_mesh import NOISY, rank_ep, rank_expert_tp, serve
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve as launcher
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import model as TM
from repro_torch.models.layers import CrossbarMode
from repro_torch.serving import ServingEngine
from repro_torch.tree import flatten

RANKS = 4
MAX_NEW = 3
REL_MAX = 5e-3  # the reference's bar for a mesh body against one device
JAX_REL_MAX = 1e-4  # the port's bar for a whole model's logits against the JAX package's
PROMPTS = [np.array([1, 2, 3], np.int32), np.array([9, 4, 7, 30, 2], np.int32)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX package's engine on a (1, 4) mesh of host devices, digital, from
# the same params: its tokens and the active slots' logits at every tick.
_JAX_MESH_ENGINE = """
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro import configs
from repro.serving import ServingEngine

d, prompts, max_new = sys.argv[1], json.loads(sys.argv[2]), int(sys.argv[3])
cfg = dataclasses.replace(configs.reduced(configs.get_config("deepseek-v2-236b")), layout="ep_only")
params = {}
with np.load(f"{d}/params.npz") as z:
    for key in z.files:
        node = params
        *path, last = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = jnp.asarray(z[key])
mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
eng = ServingEngine(cfg, params, max_batch=2, max_seq=32, mesh=mesh)
ticks, real = [], eng.runner.sample

def sample(logits):
    ticks.append(np.array(logits[[i for i, s in enumerate(eng.slots) if s is not None]]))
    return real(logits)

eng.runner.sample = sample
rids = [eng.submit(np.array(p, np.int32), max_new_tokens=max_new) for p in prompts]
done = {r.rid: r for r in eng.run_until_done()}
np.savez(f"{d}/jax_mesh.npz", tokens=np.array([done[i].generated for i in rids]),
         **{f"tick{i}": t for i, t in enumerate(ticks)})
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: its reduced model's ops are
    tiny, and a pool of threads a test worker spins against the other
    workers' on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(layout, uncapped=False):
    cfg = dataclasses.replace(reduced(get_config("deepseek-v2-236b")), layout=layout)
    if uncapped:  # every expert has a slot for every token: no body drops one
        cfg = dataclasses.replace(cfg, moe_capacity_factor=cfg.moe_experts / cfg.moe_top_k)
    return cfg


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_mesh")
    params = TM.init_model(_cfg("ep_only"), 0, device="cpu")
    np.savez(d / "params.npz", **{k: v.numpy() for k, v in flatten(params).items()})
    return d, params


@pytest.fixture(scope="module")
def ep(workdir):
    """The one-device engine on the noisy chip, its store, then the ranks,
    while the JAX package's mesh engine runs in a subprocess."""
    d, params = workdir
    cfg = _cfg("ep_only")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4 --xla_cpu_multi_thread_eigen=false")
    ref = subprocess.Popen(
        [sys.executable, "-c", _JAX_MESH_ENGINE, str(d), json.dumps([p.tolist() for p in PROMPTS]), str(MAX_NEW)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
    )
    try:
        one = ServingEngine(cfg, params, max_batch=2, max_seq=32, device="cpu",
                            crossbar=CrossbarMode(enabled=True, strict=True, device=NOISY))
        one.save_artifacts(str(d / "store"))
        served = serve(one, PROMPTS, MAX_NEW)
        ranks = run_ranks(rank_ep, RANKS, (str(d), cfg, PROMPTS, MAX_NEW), timeout_s=300)
        _, err = ref.communicate(timeout=300)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-4000:]
    with np.load(d / "jax_mesh.npz") as z:
        jax_mesh = (z["tokens"].tolist(), [z[f"tick{i}"] for i in range(len(z.files) - 1)])
    return served, ranks, jax_mesh


def test_ep_mesh_engines_serve_the_one_device_tokens(ep):
    (tokens, ticks), ranks, _ = ep
    assert all(len(t) == MAX_NEW for t in tokens)
    for r in ranks:
        for run in ("programs", "restores", "hot_swapped"):
            assert r[run][0] == tokens, (r["coords"], run)
            for a, b in zip(r[run][1], ticks):
                assert np.max(np.abs(a - b)) <= 1e-5 * np.max(np.abs(b)), (r["coords"], run)


def test_ep_mesh_engines_serve_the_jax_mesh_engines_tokens(ep):
    """Digital, each rank's ``ServingEngine(mesh=)`` against the JAX
    package's on the same mesh: the same tokens, every tick's logits within
    ``JAX_REL_MAX``."""
    _, ranks, (tokens, ticks) = ep
    assert all(len(t) == MAX_NEW for t in tokens)
    for r in ranks:
        assert r["digital"][0] == tokens, r["coords"]
        assert len(r["digital"][1]) == len(ticks)
        for a, b in zip(r["digital"][1], ticks):
            assert np.max(np.abs(a - b)) <= JAX_REL_MAX * np.max(np.abs(b)), r["coords"]


def test_ep_restored_slices_equal_the_programmed_ones(ep, workdir):
    _, ranks, _ = ep
    E = _cfg("ep_only").moe_experts
    assert all(r["slices_equal"] for r in ranks)
    assert {r["bank_shape"][1] for r in ranks} == {E // RANKS}
    assert sorted(r["coords"]["model"] for r in ranks) == list(range(RANKS))


def test_mesh_engine_runs_eager_and_refuses_the_lifecycle(ep):
    """No graph is captured under a mesh; health_check, compensate and
    refresh name the ROADMAP item; save_artifacts, a share beside the mesh,
    programming from a rank's copy and restoring beside the whole tree are
    refused."""
    _, ranks, _ = ep
    for r in ranks:
        assert r["graphs"] == (None, {})
        assert set(r["refused"]) == {"compensate", "health_check", "refresh"}
        assert all("ROADMAP" in msg for msg in r["refused"].values())


def test_expert_tp_mesh_digital_within_the_reference_bar(workdir):
    d, params = workdir
    cfg = _cfg("expert_tp", uncapped=True)
    tokens, ticks = serve(ServingEngine(cfg, params, max_batch=2, max_seq=32, device="cpu"), PROMPTS, MAX_NEW)
    ranks = run_ranks(rank_expert_tp, RANKS, (str(d), cfg, PROMPTS, MAX_NEW), timeout_s=300)
    E, D = cfg.moe_experts, cfg.d_model
    assert {r["bank_shape"][1:3] for r in ranks} == {(E // 2, D // 2)}
    assert all(r["served"][0] == ranks[0]["served"][0] for r in ranks)
    assert {"psum", "psum_scatter", "all_to_all", "all_gather"} <= set(ranks[0]["traffic"])
    for r in ranks:
        assert len(r["served"][1]) == len(ticks)
        for a, b in zip(r["served"][1], ticks):
            assert np.max(np.abs(a - b)) / np.max(np.abs(b)) < REL_MAX


def test_launcher_serves_the_engines_tokens_and_refuses_mamba():
    """``main([...])`` prints its requests' tokens: those of the engine the
    launcher builds, on the same seed's prompts; an arch the port does not
    serve (an embedding front end, since mamba is served) is refused."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launcher.main(["--arch", "deepseek-v2-236b", "--reduced", "--device", "cpu", "--requests", "3",
                       "--max-new", "4", "--max-batch", "2", "--max-seq", "64"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("[serve] 3 requests, 12 tokens")
    cfg = reduced(get_config("deepseek-v2-236b"))
    eng = ServingEngine(cfg, TM.init_model(cfg, seed=0, device="cpu"), max_batch=2, max_seq=64, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(3):
        eng.submit(rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 48))), max_new_tokens=4)
    want = [f"  req{r.rid}: {r.generated[:12]}" for r in eng.run_until_done()]
    assert lines[1:4] == want
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        launcher.main(["--arch", "musicgen-large", "--reduced", "--device", "cpu"])
