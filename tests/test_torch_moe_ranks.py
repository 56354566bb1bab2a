"""PyTorch port, the MoE FFN over rank processes (``launch.mesh`` and the
expert-parallel, all-to-all and expert-TP bodies of ``models.moe``) against
the JAX package's ``shard_map`` bodies on the same params and chip, and
``train.compression.ef_int8_psum`` against the reference's.

The test process draws the tiny MoE LM with the JAX package (8 experts, a
shared expert, the router scaled so routing is well separated: the
reference's test model, with capacity for every token in every expert so
that no body drops an assignment), programs it with the port and saves the
chip with the EP sharding recorded.  Two JAX subprocesses with 8 host
devices each (the uncapped and the capped configuration, below) restore
that store with ``mesh=`` and compute the reference's mesh outputs of the
MoE layer at top 1.  One spawn of 4 gloo ranks restores the rank slices from
that store and runs the three bodies on (1, 4) and (2, 2) meshes, at top 1
and top 2.  The bars are the reference's: EP at top 1 is bit-identical to
one device; each body is within 5e-3 (relative to max |y|) of one device,
where each rank quantizes its own input shard; and at top 1 within 1e-4 of
the JAX mesh run.  The same three bodies also run at the configuration's
capacity factor (1.25) on an input whose repeated token overflows every
body's capacity, and there each is held to the JAX mesh run alone: the
bodies bound capacity per source rank or per expert, so their drops
differ from one device's, but not from the reference's."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from benchmarks.noise_sweep import tiny_moe_lm_config
from repro.models import model as JM
from repro.train.compression import _quantize_int8 as j_quantize
from repro_torch.checkpoint import restore_programmed, save_programmed
from repro_torch.device import programmed as tprog
from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.models import moe as TMoE
from repro_torch.train import compression as tcomp

from _moe_ranks import counting_drops, forward, load_params, moe_layer, rank_ef, rank_moe
from _moe_serving import port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BODIES = ["ep", "alltoall", "expert_tp"]
TOPK = [1, 2]
# (K1 calls a layer: router + local experts x 3 + shared expert x 3)
CALLS = {"ep": 1 + 2 * 3 + 3, "alltoall": 1 + 2 * 3 + 3, "expert_tp": 1 + 4 * 3 + 3}


# the tiny MoE LM as the reference's sharded tests set it, with capacity
# for every token in every expert
CONFIG = dict(moe_experts=8, moe_top_k=1, moe_capacity_factor=8.0, moe_shared_experts=1, layout="ep_only")
# the configuration's capacity factor, and the input that overflows it: 20
# copies of one token opening each of 2 rows of 32 fill one expert past the
# capacity of one device (16 slots for 64 tokens), of an all-to-all source
# rank (8 for 16) and of an expert-TP data rank (8 for 32)
CAPPED = dict(CONFIG, moe_capacity_factor=1.25)
CAP_SHAPE, CAP_COPIES = (2, 32), 20


def _config():
    return dataclasses.replace(tiny_moe_lm_config(), **CONFIG)


_JAX_REF = """
import dataclasses as dc, json, os, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.checkpoint import restore_programmed
from repro.device.programmed import _push_bind_map, name_scope
from repro.models import layers as L, moe as Mo
from repro.models.layers import layout_overrides, use_mesh
from benchmarks.noise_sweep import tiny_moe_lm_config

out, tag = sys.argv[1], sys.argv[2]
cfg = dc.replace(tiny_moe_lm_config(), **json.loads(sys.argv[3]))
with np.load(os.path.join(out, "params.npz")) as z:
    f0 = {k.split("/")[-1]: jnp.asarray(z[k][0]) for k in z.files if k.startswith("stage0/b0/ffn/")}
with np.load(os.path.join(out, "inputs.npz")) as z:
    x = jnp.asarray(z["x" if tag == "1" else "x_cap"])
mesh14 = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
pm = restore_programmed(os.path.join(out, "store"), mesh=mesh14)
mode = L.CrossbarMode(enabled=True, fast=True, programmed=pm, strict=True)
layer0 = {n: a.layer(0) for n, a in pm.by_name.items() if n.startswith("stage0/b0/ffn/")}

def run(cfg, shape, xx):
    def f(p, xx):
        with L.crossbar_mode(mode), _push_bind_map(layer0), name_scope("stage0"), name_scope("b0"), \\
                name_scope("ffn"):
            return Mo.moe_ffn(p, xx, cfg)
    mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape), ("data", "model"))
    with use_mesh(mesh, layout_overrides(cfg)), mesh:
        return np.asarray(jax.jit(f)(f0, xx))

res = {"wi_sharding": np.asarray(str(pm.by_name["stage0/b0/ffn/wi"].w_codes.sharding.spec))}
res[f"ep/{tag}"] = run(cfg, (1, 4), x)
res[f"alltoall/{tag}"] = run(dc.replace(cfg, moe_dispatch="alltoall"), (1, 4), x)
res[f"expert_tp/{tag}"] = run(dc.replace(cfg, layout="expert_tp"), (2, 2), x)
np.savez(os.path.join(out, f"jax_out_{tag}.npz"), **res)
"""


def _one_device(d):
    """The port's one-device layer (top 1 and 2) and whole forward, from the
    whole chip."""
    cfg = port_config(_config())
    params = load_params(os.path.join(d, "params.npz"))
    chip = restore_programmed(os.path.join(d, "store"), device="cpu")
    with np.load(os.path.join(d, "inputs.npz")) as z:
        x, tokens = torch.from_numpy(z["x"]), torch.from_numpy(z["tokens"])
    out = {f"single/{k}": moe_layer(params, chip, dataclasses.replace(cfg, moe_top_k=k), None, x) for k in TOPK}
    with np.load(os.path.join(d, "inputs.npz")) as z:
        x_cap = torch.from_numpy(z["x_cap"])
    dropped = []
    with counting_drops(dropped):
        y = moe_layer(params, chip, port_config(dataclasses.replace(_config(), **CAPPED)), None, x_cap)[0]
    out["single/capped"] = (y, sum(dropped))
    out["forward"] = forward(params, chip, cfg, None, tokens)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The params and inputs (numpy) and the chip (the port's, with the EP
    sharding of a (1, 4) mesh recorded); then, at once, the JAX mesh outputs
    (one subprocess), the 4 ranks and the port's one-device run."""
    d = str(tmp_path_factory.mktemp("moe_ranks"))
    jcfg = _config()
    jparams, _ = JM.init_model(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    flat = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    flat["stage0/b0/ffn/router"] = flat["stage0/b0/ffn/router"] * np.float32(100.0)  # well-separated logits
    np.savez(os.path.join(d, "params.npz"), **flat)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, jcfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 8))
    x_cap = rng.normal(size=(*CAP_SHAPE, jcfg.d_model)).astype(np.float32)
    x_cap[:, :CAP_COPIES] = x_cap[0, 0]
    np.savez(os.path.join(d, "inputs.npz"), x=x, tokens=tokens, x_cap=x_cap)
    tcfg, tparams = port_config(jcfg), load_params(os.path.join(d, "params.npz"))
    chip = tprog.program_model(tparams, tie_lm_head=True, device="cpu")
    mesh = Mesh((1, 4), ("data", "model"))
    save_programmed(os.path.join(d, "store"), tprog.shard_artifacts(chip, mesh, TMoE.param_specs(tparams, tcfg, mesh)))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"), REPO])
    # the uncapped and the capped runs in two subprocesses at once
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(_JAX_REF), d, tag, json.dumps(c)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for tag, c in (("1", CONFIG), ("capped", CAPPED))]
    try:
        with ThreadPoolExecutor(1) as pool:
            capped = port_config(dataclasses.replace(jcfg, **CAPPED))
            ranks = pool.submit(run_ranks, rank_moe, 4, (d, tcfg, capped), timeout_s=300)
            one = _one_device(d)
            ranks = ranks.result()
        errs = [proc.communicate(timeout=300)[1] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, err in zip(procs, errs):
        assert proc.returncode == 0, err[-4000:]
    jax_out = {}
    for tag in ("1", "capped"):
        with np.load(os.path.join(d, f"jax_out_{tag}.npz")) as z:
            jax_out.update({k: z[k] for k in z.files})
    return jax_out, ranks, one


@pytest.fixture(scope="module")
def jax_out(runs):
    return runs[0]


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[1]


@pytest.fixture(scope="module")
def one_device(runs):
    return runs[2]


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def test_the_jax_package_places_the_port_store_as_recorded(jax_out):
    """The JAX package restores the port's store with ``mesh=`` to the
    recorded EP spec (its own mesh run serves from those shards)."""
    assert str(jax_out["wi_sharding"]) == str(jax.sharding.PartitionSpec(None, "model", None, None))


def test_each_rank_restores_only_its_slices(ranks):
    for r, res in enumerate(ranks):
        assert res["coords"] == ({"data": 0, "model": r}, {"data": r // 2, "model": r % 2})
        s14, s22 = res["shapes14"], res["shapes22"]
        assert s14["stage0/b0/ffn/wi"] == (1, 2, 16, 16) and s14["stage0/b0/ffn/router"] == (1, 16, 8)
        assert s22["stage0/b0/ffn/wi"] == (1, 4, 8, 16) and s22["stage0/b0/ffn/wo"] == (1, 4, 8, 16)
        assert s22["stage0/b0/ffn/router"] == (1, 8, 8) and s22["stage0/b0/mixer/wq"] == s14["stage0/b0/mixer/wq"]


def test_collectives_follow_the_reference_semantics(ranks):
    xs = [np.arange(8, dtype=np.float32).reshape(4, 2) + 100 * r for r in range(4)]
    for r, res in enumerate(ranks):
        got = res["collectives"]
        d, m = r // 2, r % 2
        model_peers = [2 * d, 2 * d + 1]
        np.testing.assert_array_equal(got["psum"], xs[model_peers[0]] + xs[model_peers[1]])
        data_peers = [m, 2 + m]  # split dim 0 in two, block j to data rank j
        np.testing.assert_array_equal(got["all_to_all"], np.concatenate([xs[p][2 * d:2 * d + 2] for p in data_peers]))
        np.testing.assert_array_equal(got["psum_scatter"], (xs[model_peers[0]] + xs[model_peers[1]])[2 * m:2 * m + 2])
        np.testing.assert_array_equal(got["all_gather"], np.concatenate(xs, axis=1))


@pytest.mark.parametrize("r", range(4))
def test_ep_at_top_1_is_bit_identical_to_one_device(ranks, one_device, r):
    assert np.array_equal(ranks[r]["ep/1"][0], one_device["single/1"][0])


@pytest.mark.parametrize("r", range(4))
def test_ep_whole_forward_is_bit_identical_to_one_device(ranks, one_device, r):
    assert np.array_equal(ranks[r]["forward/ep"], one_device["forward"])


@pytest.mark.parametrize("body", BODIES)
def test_bodies_match_the_jax_mesh_run(ranks, jax_out, body):
    """Every rank returns the whole output; each is the reference's mesh
    output within 1e-4 (float rounding of the two packages' elementwise
    ops and sums), and all ranks agree bit for bit, at top 1 and top 2."""
    for k in TOPK:
        ys = [res[f"{body}/{k}"][0] for res in ranks]
        assert all(np.array_equal(y, ys[0]) for y in ys)
    assert _rel(ranks[0][f"{body}/1"][0], jax_out[f"{body}/1"]) < 1e-4


@pytest.mark.parametrize("k", TOPK)
@pytest.mark.parametrize("body", BODIES)
def test_bodies_are_within_the_reference_bar_of_one_device(ranks, one_device, body, k):
    y = ranks[0][f"{body}/{k}"][0]
    assert _rel(y, one_device[f"single/{k}"][0]) < 5e-3


@pytest.mark.parametrize("body", BODIES)
def test_each_rank_serves_every_projection_from_its_chip(ranks, body):
    """No miss under strict mode; one K1 call a local expert's projection,
    the router and the shared expert; expert-TP consumes the router and
    every bank by name."""
    for res in ranks:
        _, calls, consumed, misses = res[f"{body}/1"]
        assert misses == [] and calls == CALLS[body]
        for n in ("router", "wi", "wg", "wo", "shared_wi", "shared_wg", "shared_wo"):
            assert f"stage0/b0/ffn/{n}" in consumed


@pytest.mark.parametrize("body", BODIES)
def test_capped_bodies_drop_and_match_the_jax_mesh_run(ranks, jax_out, body):
    """At the configuration's capacity factor each body drops assignments
    (summed over its ranks' dispatches) and still gives the reference's
    mesh output within 1e-4, the same on every rank."""
    ys = [res["capped"][body][0] for res in ranks]
    assert all(np.array_equal(y, ys[0]) for y in ys)
    assert sum(res["capped"][body][1] for res in ranks) > 0
    assert _rel(ys[0], jax_out[f"{body}/capped"]) < 1e-4


def test_capped_ep_is_bit_identical_to_one_device(ranks, one_device):
    """EP bounds each expert's capacity over every token, as one device
    does, so at top 1 it drops the same assignments and gives the same
    bits."""
    y_one, dropped_one = one_device["single/capped"]
    assert dropped_one > 0 and sum(res["capped"]["ep"][1] for res in ranks) == dropped_one
    for res in ranks:
        assert np.array_equal(res["capped"]["ep"][0], y_one)


def test_expert_tp_from_the_whole_chip_equals_its_restored_slices(ranks):
    for res in ranks:
        assert np.array_equal(res["expert_tp/1/whole_chip"][0], res["expert_tp/1"][0])
        assert res["expert_tp/1/whole_chip"][3] == []


def test_the_wire_carries_the_activations_dtype(ranks):
    t14, t22 = ranks[0]["traffic"]
    assert set(t14) == {"psum", "all_to_all", "all_gather"}
    assert set(t22) == {"psum", "all_to_all", "psum_scatter", "all_gather"}
    assert all(set(by_dtype) == {"float32"} for t in (t14, t22) for by_dtype in t.values())


# ---------------------------------------------------------------------------
# Error-feedback int8 all-reduce
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grads():
    return np.random.default_rng(5).normal(size=(8, 1024)).astype(np.float32)


@pytest.fixture(scope="module")
def ef_ranks(grads):
    return run_ranks(rank_ef, 8, (grads, 20), timeout_s=300)


def test_quantize_int8_is_bit_equal_to_the_reference(grads):
    for row in list(grads) + [grads[0] * 1e-20, np.zeros(16, np.float32)]:
        q, scale = tcomp._quantize_int8(torch.from_numpy(row))
        jq, jscale = j_quantize(jnp.asarray(row))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert scale.numpy().tobytes() == np.asarray(jscale).tobytes()


def test_one_step_is_the_mean_of_the_dequantized_rows(grads, ef_ranks):
    """One step from a zero residual: the mean over ranks of the JAX
    codes times their scales (float32; the sum's order is gloo's)."""
    deq = []
    for row in grads:
        jq, jscale = j_quantize(jnp.asarray(row))
        deq.append(np.asarray(jq).astype(np.float32) * np.float32(jscale))
    want = np.mean(np.stack(deq), axis=0, dtype=np.float32)
    for one, _ in ef_ranks:
        np.testing.assert_allclose(one, want, rtol=1e-6, atol=1e-7)


def test_error_feedback_makes_the_average_accurate(grads, ef_ranks):
    """The reference's property over 20 steps: the averaged compressed
    mean drifts less than one compressed step errs, and under 2 %."""
    true = np.mean(grads, axis=0)
    scale = float(np.max(np.abs(true))) + 1e-9
    for one, mean in ef_ranks:
        drift = float(np.max(np.abs(mean - true))) / scale
        one_err = float(np.max(np.abs(one - true))) / scale
        assert drift < one_err and drift < 0.02
