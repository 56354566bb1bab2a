"""PyTorch port, ``launch.sharding`` and ``models.model.param_axes`` against
the JAX package's ``repro.launch.sharding`` and ``init_model(...)[1]``.

Every registered config at reduced size: the axes tree leaf by leaf; then,
on (data, model) meshes (1, 4), (2, 2) and (4, 1) under the ``tp``,
``pure_dp``, ``ep_only`` and ``expert_tp`` layouts, the specs of
``param_shardings`` (FSDP off and on), ``opt_state_shardings`` (AdamW,
Adafactor, SGD), ``batch_shardings`` and ``cache_shardings`` against the
reference's ``.spec``.  At reduced size no leaf reaches FSDP's 4M elements
and Adafactor factors none, so both are also held at full size, from the
reference's shapes (nothing is allocated on either side).  The reference's specs are computed once, on
``jax.sharding.AbstractMesh``es (its functions read only a mesh's axis
names and sizes), and cached in a module fixture; ``PartitionSpec`` writes
a one-axis tuple entry as the bare name, and so does the port."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro import optim as jopt
from repro.launch import sharding as jsh
from repro.models import layers as jlayers
from repro.models import model as JM
from repro_torch.configs import ALL_ARCHS, get_config, reduced
from repro_torch.launch import sharding as tsh
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as TM
from repro_torch.models.layers import layout_overrides, use_mesh
from repro_torch.optim import constant, make_optimizer
from repro_torch.tree import flatten

MESHES = ((1, 4), (2, 2), (4, 1))
LAYOUTS = ("tp", "pure_dp", "ep_only", "expert_tp")
OPTS = ("adamw", "adafactor", "sgd")
BATCH_ROWS = (1, 2, 4, 8)
CACHE = ((1, 32), (4, 32))  # (batch, seq): a batch that does not divide shards the sequence
AXES = ("data", "model")


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict / list tree (lists as indices)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _ref_specs(tree):
    return {k: tuple(s.spec) for k, s in _flat(jax.tree.map(lambda s: s, tree, is_leaf=lambda x: hasattr(x, "spec"))).items()}


def _configs(arch):
    """{layout: (jax cfg, port cfg)} at reduced size."""
    j, t = jconfigs.reduced(jconfigs.get_config(arch)), reduced(get_config(arch))
    return {lay: (dataclasses.replace(j, layout=lay), dataclasses.replace(t, layout=lay)) for lay in LAYOUTS}


def _reference(arch):
    """{(mesh shape, layout): {kind: {path: spec}}} from the JAX package."""
    out = {}
    for shape in MESHES:
        mesh = AbstractMesh(shape, AXES)
        for lay, (cfg, _) in _configs(arch).items():
            with jlayers.use_mesh(mesh, jlayers.layout_overrides(cfg)):
                p_shapes, axes = JM.init_model(jax.random.PRNGKey(0), cfg, shape_only=True)
                got = {f"params/fsdp={f}": _ref_specs(jsh.param_shardings(p_shapes, axes, mesh, fsdp=f))
                       for f in (False, True)}
                p_sh = jsh.param_shardings(p_shapes, axes, mesh)
                for name in OPTS:
                    state = jax.eval_shape(jopt.make_optimizer(name, jopt.constant(1e-3)).init, p_shapes)
                    got[f"opt/{name}"] = _ref_specs(jsh.opt_state_shardings(name, state, p_sh, mesh))
                got["batch"] = _ref_specs(jsh.batch_shardings(
                    {f"{k}{b}": jax.ShapeDtypeStruct((b, 16), jnp.int32) for b in BATCH_ROWS for k in ("inputs", "mask")},
                    mesh,
                ))
                for b, s in CACHE:
                    cache = jax.eval_shape(lambda: JM.init_cache(cfg, b, s))
                    got[f"cache/{b}x{s}"] = _ref_specs(jsh.cache_shardings(cache, JM.cache_axes(cfg), mesh))
            out[(shape, lay)] = got
    return out


def _port(arch):
    out = {}
    for shape in MESHES:
        mesh = Mesh(shape, AXES)
        for lay, (_, cfg) in _configs(arch).items():
            with use_mesh(mesh, layout_overrides(cfg)):
                p_shapes = tsh.abstract(TM.init_model(cfg, 0, device="cpu"))
                axes = TM.param_axes(cfg)
                got = {f"params/fsdp={f}": _flat(tsh.param_shardings(p_shapes, axes, mesh, fsdp=f)) for f in (False, True)}
                p_sh = tsh.param_shardings(p_shapes, axes, mesh)
                for name in OPTS:
                    state = make_optimizer(name, constant(1e-3)).init(p_shapes)
                    got[f"opt/{name}"] = _flat(tsh.opt_state_shardings(name, state, p_sh, mesh))
                got["batch"] = _flat(tsh.batch_shardings(
                    {f"{k}{b}": (b, 16) for b in BATCH_ROWS for k in ("inputs", "mask")}, mesh,
                ))
                for b, s in CACHE:
                    cache = TM.init_cache(cfg, b, s, device="meta")
                    got[f"cache/{b}x{s}"] = _flat(tsh.cache_shardings(cache, TM.cache_axes(cfg), mesh))
            out[(shape, lay)] = got
    return out


@pytest.fixture(scope="module")
def specs():
    """The reference's specs and the port's, per arch, computed once."""
    return {arch: (_reference(arch), _port(arch)) for arch in ALL_ARCHS}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_axes_equal_the_reference_axes_tree(arch):
    jcfg, tcfg = jconfigs.reduced(jconfigs.get_config(arch)), reduced(get_config(arch))
    shapes, axes = JM.init_model(jax.random.PRNGKey(0), jcfg, shape_only=True)
    assert _flat(TM.param_axes(tcfg)) == _flat(axes)
    port = {k: tuple(v.shape) for k, v in flatten(TM.init_model(tcfg, 0, device="cpu")).items()}
    assert port == {k: tuple(s.shape) for k, s in _flat(shapes).items()}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_axes_at_full_size(arch):
    """The full config's axes (the tree the card's mesh phases shard)."""
    _, axes = JM.init_model(jax.random.PRNGKey(0), jconfigs.get_config(arch), shape_only=True)
    assert _flat(TM.param_axes(get_config(arch))) == _flat(axes)


@pytest.mark.parametrize("kind", ["params", "opt", "batch", "cache"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_specs_equal_the_reference(specs, arch, kind):
    ref, port = specs[arch]
    assert ref.keys() == port.keys()
    checked = 0
    for case, got in ref.items():
        for name, want in got.items():
            if name.split("/")[0] != kind:
                continue
            assert port[case][name] == want, (arch, case, name)
            checked += len(want)
    assert checked


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_fsdp_param_and_state_specs_at_full_size(arch):
    """FSDP shards the leaves of 4M elements and more, and Adafactor
    factors the leaves whose last two dims reach 128 (its ``vr`` / ``vc``
    take the spec less its last entry): at full size, from the reference's
    shapes (the port's as ``meta`` tensors of them)."""
    jcfg = jconfigs.get_config(arch)
    tcfg = get_config(arch)
    shapes, axes = JM.init_model(jax.random.PRNGKey(0), jcfg, shape_only=True)
    tshapes = _meta(shapes)
    sharded = factored = 0
    for shape in MESHES:
        mesh, tmesh = AbstractMesh(shape, AXES), Mesh(shape, AXES)
        for lay in ("tp", "pure_dp"):
            jc, tc = dataclasses.replace(jcfg, layout=lay), dataclasses.replace(tcfg, layout=lay)
            with jlayers.use_mesh(mesh, jlayers.layout_overrides(jc)):
                p_sh = jsh.param_shardings(shapes, axes, mesh, fsdp=True)
                want = {"params": _ref_specs(p_sh)}
                for name in ("adamw", "adafactor"):
                    state = jax.eval_shape(jopt.make_optimizer(name, jopt.constant(1e-3)).init, shapes)
                    want[name] = _ref_specs(jsh.opt_state_shardings(name, state, p_sh, mesh))
            with use_mesh(tmesh, layout_overrides(tc)):
                p_specs = tsh.param_shardings(tshapes, TM.param_axes(tcfg), tmesh, fsdp=True)
                got = {"params": _flat(p_specs)}
                for name in ("adamw", "adafactor"):
                    state = make_optimizer(name, constant(1e-3)).init(tshapes)
                    got[name] = _flat(tsh.opt_state_shardings(name, state, p_specs, tmesh))
            assert got == want, (arch, shape, lay)
            sharded += sum("data" in s for s in got["params"].values())
            factored += sum(k.endswith("/vr") and any(s) for k, s in got["adafactor"].items())
    assert sharded and factored


def _meta(shapes):
    """The reference's shape tree as ``meta`` tensors (no memory)."""
    return jax.tree.map(lambda s: torch.empty(tuple(s.shape), dtype=torch.float32, device="meta"), shapes)


def test_local_slice_and_gather_round_trip():
    """A rank's block by its coordinates (no process group: each rank of a
    (2, 2) layout sliced in turn), and the blocks put back in order."""
    cfg = reduced(get_config("smollm-360m"))
    params = TM.init_model(cfg, 0, device="cpu")
    mesh = Mesh((2, 2), AXES)
    with use_mesh(mesh, layout_overrides(cfg)):
        specs = tsh.param_shardings(params, TM.param_axes(cfg), mesh)
    wq = params["stage0"]["b0"]["mixer"]["wq"]
    spec = specs["stage0"]["b0"]["mixer"]["wq"]
    assert spec == (None, None, "model")
    blocks = [tsh.local_block(wq, spec, Mesh((2, 2), AXES, r)) for r in range(4)]
    assert blocks[0].shape == tsh.local_shape(wq.shape, spec, mesh) == (2, 64, 32)
    assert torch.equal(blocks[0], blocks[2]) and torch.equal(torch.cat(blocks[:2], dim=2), wq)
    table = params["embed"]["tokens"]
    assert torch.equal(tsh.local_block(table, ("model", None), Mesh((2, 2), AXES, 3)), table[128:])
