"""PyTorch port, sharding in one process: ``dividing_pspec``,
``artifact_shard_specs``, ``with_arrays``, ``local_artifact`` (repair tables
re-indexed to local columns), ``shard_artifacts``' placement record, the
store's ``sharding`` entry both ways, ``restore_programmed(mesh=)`` and the
MoE layouts' specs, each against the JAX package's on the same artifacts.
The chips are programmed by the port and cross into the JAX package
through the store (the JAX package's device programming would spend the
file's time compiling); a rank is a ``Mesh`` with a rank and no process
group (the slicing needs no collective)."""
import glob
import json
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from benchmarks.noise_sweep import tiny_moe_lm_config
from repro.analysis import verify_store as j_verify
from repro.checkpoint import restore_programmed as j_restore, save_programmed as j_save
from repro.device import programmed as jprog
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.analysis import verify_store as t_verify
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.checkpoint import restore_programmed as t_restore, save_programmed as t_save
from repro_torch.convert import params_from_numpy
from repro_torch.device import DeviceConfig
from repro_torch.device import programmed as tprog
from repro_torch.launch.mesh import Mesh, make_mesh, make_production_mesh
from repro_torch.models import moe as TMoE
from repro_torch.models.layers import dividing_entry, layout_overrides, pspec, use_mesh

from _moe_serving import port_config as _port_config

# the reference's test chips (tests/test_sharded_artifacts.py)
REPAIRED = DeviceConfig(sigma=0.05, p_stuck_on=2e-2, p_stuck_off=2e-2, write_verify_iters=2, spare_cols=8, seed=7)
NOISY = DeviceConfig(sigma=0.05, p_stuck_on=1e-3, p_stuck_off=1e-3, write_verify_iters=2)


def _entries(spec):
    return tuple(spec)


def _port_art(shape, device, seed=0):
    w = torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))
    return tprog.program_layer(w, device_cfg=device)


@pytest.fixture(scope="module")
def chips(tmp_path_factory):
    """The port's artifacts and the JAX package's reading of them (carried
    by the store): a repaired 2-D chip, a noisy (E, K, N) bank and an ideal
    (L, E, K, N) bank."""
    tarts = {
        "flat": _port_art((64, 32), REPAIRED),
        "bank3": _port_art((4, 64, 32), NOISY, seed=1),
        "bank4": _port_art((2, 4, 32, 16), None, seed=2),
    }
    assert tarts["flat"].repair.n_repaired > 0
    d = str(tmp_path_factory.mktemp("chips"))
    t_save(d, tprog.ProgrammedModel(dict(tarts)))
    jarts = j_restore(d).by_name
    return jarts, tarts


def _assert_fields_equal(t_art, j_art):
    for f in tprog.ARTIFACT_ARRAY_FIELDS:
        a, b = getattr(t_art, f), getattr(j_art, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec, shape, sizes", [
    (("model", None), (64, 32), {"model": 4}),
    (("model", None), (6, 32), {"model": 4}),  # does not divide
    ((None, "data"), (8, 8), {"model": 2}),  # axis unknown to the mesh
    ((("data", "model"), None, None), (8, 4, 4), {"data": 2, "model": 2}),
    ((("data", "model"), None), (6, 4), {"data": 2, "model": 2}),
    (("model",), (8, 3, 5), {"model": 8}),  # shorter than the shape
])
def test_dividing_pspec_matches_the_reference(spec, shape, sizes):
    assert tprog.dividing_pspec(spec, shape, sizes) == _entries(jprog.dividing_pspec(P(*spec), shape, sizes))


@pytest.mark.parametrize("which, spec", [
    ("bank3", ("model", None, None)),
    ("bank3", (None, "model", None)),
    ("bank3", (None, None, "model")),
    ("bank4", (None, "model", None, None)),
    ("bank4", (None, "data", "model", None)),
    ("flat", (None, "model")),
    ("flat", ("model",)),
])
def test_artifact_shard_specs_match_the_reference(chips, which, spec):
    jarts, tarts = chips
    got = tprog.artifact_shard_specs(tarts[which], spec)
    ref = jprog.artifact_shard_specs(jarts[which], P(*spec))
    assert got == {f: _entries(s) for f, s in ref.items()}


def test_a_spec_longer_than_the_weight_is_refused(chips):
    with pytest.raises(ValueError):
        tprog.artifact_shard_specs(chips[1]["flat"], (None, None, "model"))


def test_with_arrays_round_trips_and_drops_the_global_records(chips):
    art = tprog.shard_artifacts(tprog.ProgrammedModel({"w": chips[1]["flat"]}), Mesh((1, 2), ("data", "model")),
                                {"w": (None, "model")}).by_name["w"]
    assert art.sharding and art.repair is not None
    back = tprog.with_arrays(art, tprog.artifact_arrays(art))
    assert tprog.artifacts_equal(art, back)
    assert back.report is None and back.repair is None and back.sharding is None
    part = tprog.with_arrays(art, {"w_codes": art.w_codes, "w_colsum": art.w_colsum, "w_scale": art.w_scale})
    assert part.g_eff is None and part.out_gather is None


# ---------------------------------------------------------------------------
# Rank slices
# ---------------------------------------------------------------------------

SLICES = [
    ("bank3", ("model", None, None), {"model": 2}, [{"model": 0}, {"model": 1}]),
    ("bank3", (None, "model", None), {"model": 4}, [{"model": 3}]),
    ("bank4", (None, "model", None, None), {"model": 4}, [{"model": r} for r in range(4)]),
    ("bank4", (None, "data", "model", None), {"data": 2, "model": 2},
     [{"data": d, "model": m} for d in range(2) for m in range(2)]),
    ("bank4", (None, ("data", "model"), None, None), {"data": 2, "model": 2}, [{"data": 1, "model": 0}]),
    ("flat", (None, "model"), {"model": 2}, [{"model": 0}, {"model": 1}]),
    ("flat", (None, "model"), {"model": 4}, [{"model": r} for r in range(4)]),
    ("flat", ("model", None), {"model": 2}, [{"model": 1}]),
    ("flat", (None, "model"), {"model": 3}, [{"model": 2}]),  # 32 columns do not split over 3
]


@pytest.mark.parametrize("which, spec, sizes, ranks", SLICES)
def test_local_artifact_matches_the_reference(chips, which, spec, sizes, ranks):
    """Every field of every listed rank's slice equals the reference's,
    the repaired chip's routing tables re-indexed to local columns and its
    spare block compacted the same way."""
    jarts, tarts = chips
    for coords in ranks:
        got = tprog.local_artifact(tarts[which], spec, sizes, coords)
        ref = jprog.local_artifact(jarts[which], P(*spec), sizes, coords)
        _assert_fields_equal(got, ref)
        assert got.report is None and got.repair is None


def test_repaired_columns_point_at_their_local_spares(chips):
    """The reference's consistency check on the re-indexed record: every
    repaired local column's cells equal the local spare it points to, and
    every repair is seen once over the ranks."""
    tart = chips[1]["flat"]
    n_loc, rows, seen = 16, int(tart.spec.rows), 0
    for rank in (0, 1):
        loc = tprog.local_artifact(tart, (None, "model"), {"model": 2}, {"model": rank})
        g, glob = loc.out_gather.numpy(), tart.out_gather.numpy()[:, :, rank * n_loc:(rank + 1) * n_loc]
        for s, r, j in zip(*np.nonzero(glob >= 32)):
            b = g[s, r, j] - n_loc
            r0, r1 = r * rows, min((r + 1) * rows, loc.g_eff.shape[1])
            np.testing.assert_array_equal(loc.g_eff[s, r0:r1, j].numpy(), loc.g_spare[s, r0:r1, b].numpy())
            seen += 1
        assert (g[glob < 32] == np.nonzero(glob < 32)[2]).all()
    assert seen == tart.repair.n_repaired


def test_an_expert_slice_serves_as_the_global_bank(chips):
    """Expert-sharded slices serve each expert bit-identically to the
    global bank (the reference's rank-local serving invariant)."""
    tart = chips[1]["bank3"]
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 64)).astype(np.float32))
    whole = [tprog.programmed_linear(x, tart.layer(e)) for e in range(4)]
    for r in range(2):
        loc = tprog.local_artifact(tart, ("model", None, None), {"model": 2}, {"model": r})
        for i in range(2):
            assert torch.equal(tprog.programmed_linear(x, loc.layer(i)), whole[2 * r + i])


# ---------------------------------------------------------------------------
# Placement records and the store
# ---------------------------------------------------------------------------

SPECS = {"flat": (None, "model"), "bank3": ("model", None, None), "bank4": (None, "model", None, None)}


def _jax_mesh11():
    return JMesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _manifest(d):
    with open(os.path.join(d, "programmed", "manifest.json")) as f:
        return json.load(f)["artifacts"]


def test_shard_artifacts_records_what_the_reference_records(chips):
    """On a (1, 1) mesh every named entry divides, so the record is the
    derived specs; the reference's is read off its arrays' placement."""
    jarts, tarts = chips
    jsh = jprog.shard_artifacts(jprog.ProgrammedModel(dict(jarts)), _jax_mesh11(), {n: P(*s) for n, s in SPECS.items()})
    tsh = tprog.shard_artifacts(tprog.ProgrammedModel(dict(tarts)), Mesh((1, 1), ("data", "model")), SPECS)
    from repro.checkpoint.checkpoint import _artifact_shardings as j_record

    for n in SPECS:
        assert tckpt._artifact_shardings(tsh.by_name[n]) == j_record(jsh.by_name[n]), n
    # a mesh that splits nothing the spec names records nothing
    none = tprog.shard_artifacts(tprog.ProgrammedModel(dict(tarts)), Mesh((2,), ("data",)), SPECS)
    assert all(a.sharding is None for a in none.by_name.values())


def test_a_jax_store_passes_through_the_port_with_its_record(chips, tmp_path):
    jarts, _ = chips
    jsh = jprog.shard_artifacts(jprog.ProgrammedModel(dict(jarts)), _jax_mesh11(), {n: P(*s) for n, s in SPECS.items()})
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    j_save(a, jsh)
    rec = {n: info["sharding"] for n, info in _manifest(a).items()}
    assert rec["bank3"]["w_codes"] == ["model", None, None]
    t_save(b, t_restore(a, device="cpu"))
    assert {n: info["sharding"] for n, info in _manifest(b).items()} == rec
    assert t_verify(b).ok and j_verify(b).ok
    back = j_restore(b, mesh=_jax_mesh11())
    for n, spec in SPECS.items():
        assert tuple(back.by_name[n].w_codes.sharding.spec) == spec, n
        assert jprog.artifacts_equal(back.by_name[n], jarts[n])


def test_a_port_store_restores_in_jax_to_the_same_specs(chips, tmp_path):
    _, tarts = chips
    d = str(tmp_path)
    t_save(d, tprog.shard_artifacts(tprog.ProgrammedModel(dict(tarts)), Mesh((1, 1), ("data", "model")), SPECS))
    assert j_verify(d).ok and t_verify(d).ok
    back = j_restore(d, mesh=_jax_mesh11())
    for n, spec in SPECS.items():
        art = back.by_name[n]
        placed = {f: s for f, s in tprog.artifact_shard_specs(tarts[n], spec).items() if any(s)}
        assert "w_codes" in placed
        for f, fspec in placed.items():
            assert tuple(getattr(art, f).sharding.spec) == fspec, (n, f)


@pytest.mark.parametrize("compressed", [False, True], ids=["stored", "compressed"])
def test_restore_with_a_mesh_gives_each_rank_its_slice(chips, tmp_path, compressed):
    """A store recorded on a (1, 1) mesh restored by each rank of a (1, 4)
    mesh: every artifact is the rank's slice by its recorded spec (the
    reference's ``local_artifact`` of it), repair tables re-indexed, no
    record on a slice; ``specs=`` lays an artifact out anew.  The members
    are memory-mapped; a store whose ``.npz`` files were recompressed is
    read whole, to the same slices."""
    jarts, _ = chips
    d = str(tmp_path)
    j_save(d, jprog.shard_artifacts(jprog.ProgrammedModel(dict(jarts)), _jax_mesh11(),
                                    {n: P(*s) for n, s in SPECS.items()}))
    if compressed:
        for f in glob.glob(os.path.join(d, "programmed", "*.npz")):
            with np.load(f) as z:
                arrays = {k: z[k] for k in z.files}
            np.savez_compressed(f, **arrays)
    sizes = {"data": 1, "model": 4}
    for rank in range(4):
        mesh = Mesh((1, 4), ("data", "model"), rank)
        got = t_restore(d, device="cpu", mesh=mesh).by_name
        for n, spec in SPECS.items():
            _assert_fields_equal(got[n], jprog.local_artifact(jarts[n], P(*spec), sizes, mesh.coords))
            assert got[n].sharding is None
        relaid = t_restore(d, device="cpu", mesh=mesh, specs={"bank4": (None, None, "model", None)}).by_name
        _assert_fields_equal(relaid["bank4"], jprog.local_artifact(jarts["bank4"], P(None, None, "model", None),
                                                                   sizes, mesh.coords))


# ---------------------------------------------------------------------------
# Meshes and the MoE layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim, ax", [(32, ("pod", "data", "model")), (6, ("pod", "data", "model")), (8, "model"),
                                     (6, "model"), (5, ("pod", "data")), (4, None)])
def test_dividing_entry_is_the_references(dim, ax):
    mesh = types.SimpleNamespace(shape={"pod": 2, "data": 2, "model": 4})
    assert dividing_entry(dim, ax, mesh) == JL.dividing_entry(dim, ax, mesh)


def test_mesh_coordinates_are_row_major_and_sizes_are_checked():
    m = Mesh((2, 3), ("data", "model"), rank=4)
    assert m.shape == {"data": 2, "model": 3} and m.size == 6
    assert m.coords == {"data": 1, "model": 1}
    assert m.axis_index(("data", "model")) == 4 and m.axis_size(("model",)) == 3
    with pytest.raises(ValueError):
        Mesh((2, 2), ("data",))
    with pytest.raises(ValueError):
        Mesh((2, 2), ("data", "model"), rank=4)
    with pytest.raises(RuntimeError, match="process groups"):
        m.psum(torch.ones(3), "model")
    with pytest.raises(RuntimeError):
        make_mesh((1, 1), ("data", "model"))  # no process group initialised
    with pytest.raises(RuntimeError, match="256"):
        make_production_mesh()


@pytest.mark.parametrize("layout, shape", [("ep_only", (1, 4)), ("expert_tp", (2, 2)), ("tp", (2, 4)),
                                           ("pure_dp", (2, 2))])
def test_moe_param_specs_are_the_references(layout, shape):
    """The router's and banks' specs under each layout are the reference's
    ``pspec`` of its logical axes (the leading stacking axis replicated)."""
    import dataclasses

    jcfg = dataclasses.replace(tiny_moe_lm_config(), moe_experts=8, moe_shared_experts=1, layout=layout)
    jparams, axes = JM.init_model(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    names = types.SimpleNamespace(axis_names=("data", "model"))
    ffn_axes = axes["stage0"]["b0"]["ffn"]
    with JL.use_mesh(names, JL.layout_overrides(jcfg)):
        ref = {f"stage0/b0/ffn/{k}": _entries(JL.pspec(ffn_axes[k], names)) for k in ("router", "wi", "wg", "wo")}
    mesh = Mesh(shape, ("data", "model"))
    assert TMoE.param_specs(tparams, _port_config(jcfg), mesh) == ref
    with JL.use_mesh(names, JL.layout_overrides(jcfg)):
        ref_act = _entries(JL.pspec(("batch", "experts", "moe_dm"), names))
    with use_mesh(mesh, layout_overrides(_port_config(jcfg))):
        act = pspec(("batch", "experts", "moe_dm"))
    # PartitionSpec writes a one-axis tuple entry as the axis name
    assert tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in act) == ref_act


def test_rank_params_slice_the_banks_by_the_specs():
    import dataclasses

    jcfg = dataclasses.replace(tiny_moe_lm_config(), moe_experts=8, moe_shared_experts=1, layout="expert_tp")
    jparams, _ = JM.init_model(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tcfg = _port_config(jcfg)
    for rank in range(4):
        mesh = Mesh((2, 2), ("data", "model"), rank)
        d, m = mesh.coords["data"], mesh.coords["model"]
        got = TMoE.rank_params(tparams, tcfg, mesh)["stage0"]["b0"]["ffn"]
        ffn = jparams["stage0"]["b0"]["ffn"]
        np.testing.assert_array_equal(got["wi"].numpy(), np.asarray(ffn["wi"])[:, 4 * d:4 * d + 4, 8 * m:8 * m + 8])
        np.testing.assert_array_equal(got["wo"].numpy(), np.asarray(ffn["wo"])[:, 4 * d:4 * d + 4, 8 * m:8 * m + 8])
        np.testing.assert_array_equal(got["router"].numpy(), np.asarray(ffn["router"])[:, 8 * m:8 * m + 8])
        np.testing.assert_array_equal(got["shared_wi"].numpy(), np.asarray(ffn["shared_wi"]))
