"""PyTorch port, the chip farm: ``ChipFarm`` routing, draining and the
lifecycle verbs on a reduced smollm-360m carried across from the JAX package
(mirrors of the reference's farm tests in ``tests/test_serving_traffic.py``),
the port's placements equal to the JAX farm's for the same submissions, and a
replica's chip swap dropping that replica's captured tick and no other's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from benchmarks.serving_traffic import SHORT_LONG
from repro import configs as jconfigs
from repro.models import model as JM
from repro.serving import ChipFarm as JFarm
from repro_torch.checkpoint import active_slot
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.device import DeviceConfig
from repro_torch.models.layers import CrossbarMode
from repro_torch.serving import ChipFarm, ServingEngine
from repro_torch.serving.farm import POLICIES, RID_STRIDE

pytestmark = pytest.mark.serving

# the reference test's drifting chip
DRIFTING = dict(sigma=0.02, drift_nu=0.05, seed=3)


@pytest.fixture(scope="module")
def tiny_lm():
    jcfg = jconfigs.reduced(jconfigs.get_config("smollm-360m"))
    tcfg = reduced(get_config("smollm-360m"))
    jparams, _ = JM.init_model(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _farm(tiny_lm, **kw):
    _, tcfg, _, tparams = tiny_lm
    return ChipFarm(tcfg, tparams, device="cpu", **kw)


def _prompt(n, lo=1):
    return (np.arange(lo, lo + n) % 60 + 1).astype(np.int32)


def _mixed_workload():
    return [
        (_prompt(5), 3),
        (_prompt(9, lo=4), 6),
        (_prompt(3, lo=9), 1),
        (_prompt(12, lo=2), 4),
        (_prompt(6, lo=7), 5),
        (_prompt(4, lo=11), 2),
    ]


def test_farm_round_robin_routing(tiny_lm):
    farm = _farm(tiny_lm, n_replicas=3, policy="round_robin", max_batch=1, max_seq=32)
    rids = [farm.submit(_prompt(4, lo=k), max_new_tokens=1) for k in range(6)]
    assert [farm.replica_of(r) for r in rids] == [0, 1, 2, 0, 1, 2]
    res = farm.run_until_done()
    assert sorted(r.rid for r in res) == sorted(rids)
    assert all(r.done for r in res)


def test_farm_least_loaded_routing(tiny_lm):
    farm = _farm(tiny_lm, n_replicas=2, policy="least_loaded", max_batch=1, max_seq=32)
    a = farm.submit(_prompt(4), max_new_tokens=4)
    b = farm.submit(_prompt(4, lo=2), max_new_tokens=4)
    c = farm.submit(_prompt(4, lo=3), max_new_tokens=1)
    assert {farm.replica_of(a), farm.replica_of(b)} == {0, 1}
    assert farm.replica_of(c) == 0
    assert len(farm.run_until_done()) == 3


def test_farm_rids_disjoint_and_results_merge(tiny_lm):
    farm = _farm(tiny_lm, n_replicas=2, max_batch=2, max_seq=32)
    rids = [farm.submit(_prompt(5, lo=k), max_new_tokens=2) for k in range(4)]
    assert len(set(rids)) == 4 and {r // RID_STRIDE for r in rids} == {0, 1}
    res = farm.run_until_done()
    assert [r.rid for r in res] == sorted(rids)


@pytest.mark.parametrize("chip", [False, True], ids=["digital", "ideal_chip"])
def test_farm_single_replica_matches_engine(tiny_lm, chip):
    _, tcfg, _, tparams = tiny_lm
    kw = dict(crossbar=CrossbarMode(enabled=True, strict=True)) if chip else {}
    farm = _farm(tiny_lm, n_replicas=1, max_batch=2, max_seq=32, seed=0, **kw)
    for p, n in _mixed_workload():
        farm.submit(p, max_new_tokens=n)
    farm_out = [r.generated for r in farm.run_until_done()]
    eng = ServingEngine(tcfg, tparams, max_batch=2, max_seq=32, seed=0, device="cpu", **kw)
    for p, n in _mixed_workload():
        eng.submit(p, max_new_tokens=n)
    assert farm_out == [r.generated for r in eng.run_until_done()]


def test_farm_drain_stops_admission_not_service(tiny_lm):
    farm = _farm(tiny_lm, n_replicas=2, max_batch=1, max_seq=32)
    r0 = farm.submit(_prompt(4), max_new_tokens=4)  # lands on replica 0
    farm.drain(0)
    assert farm.draining == frozenset({0})
    rids = [farm.submit(_prompt(4, lo=k), max_new_tokens=1) for k in range(3)]
    assert all(farm.replica_of(r) == 1 for r in rids)
    res = {r.rid: r for r in farm.run_until_done()}
    assert res[r0].done and len(res[r0].generated) == 4
    with pytest.raises(ValueError, match="draining"):
        farm.drain(1)
        farm.submit(_prompt(4))
    farm.undrain(0)
    farm.submit(_prompt(4), max_new_tokens=1)
    assert len(farm.run_until_done()) == 5


def test_farm_drain_refresh_undrain_cycle(tiny_lm, tmp_path):
    # an aged replica is drained, refreshed from a store commit and
    # undrained without dropping the other replica's traffic, and then serves
    # what a fresh restore serves
    _, tcfg, _, tparams = tiny_lm
    mode = CrossbarMode(enabled=True, device=DeviceConfig(**DRIFTING))
    d = str(tmp_path / "store")
    ServingEngine(tcfg, tparams, max_batch=1, max_seq=16, crossbar=mode, device="cpu").save_artifacts(d)
    farm = _farm(tiny_lm, n_replicas=2, max_batch=1, max_seq=16, crossbar=mode, restore_artifacts=d)
    farm.replicas[0].age(3600.0)
    assert farm.uptimes()[0] > 0.0 and farm.uptimes()[1] == 0.0
    worst = [h.worst for h in farm.health()]
    assert worst[0] > worst[1]
    farm.drain(0)
    keep = farm.submit(_prompt(4), max_new_tokens=2)
    assert farm.replica_of(keep) == 1
    assert farm.is_idle(0)
    # reprogrammed into the inactive slot, committed, hot-swapped
    assert farm.refresh(0, d) == active_slot(d)
    farm.undrain(0)
    assert farm.uptimes()[0] == 0.0
    back = farm.submit(_prompt(4, lo=2), max_new_tokens=2)
    assert farm.replica_of(back) == 0
    res = {r.rid: r for r in farm.run_until_done()}
    assert res[keep].done and res[back].done
    ref = ServingEngine(tcfg, tparams, max_batch=1, max_seq=16, crossbar=mode, restore_artifacts=d, device="cpu")
    ref.submit(_prompt(4, lo=2), max_new_tokens=2)
    assert ref.run_until_done()[0].generated == res[back].generated


def test_farm_rejects_bad_config(tiny_lm):
    with pytest.raises(ValueError, match="n_replicas"):
        _farm(tiny_lm, n_replicas=0)
    with pytest.raises(ValueError, match="policy"):
        _farm(tiny_lm, n_replicas=1, policy="random")


# ---------------------------------------------------------------------------
# Beyond the mirrors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
def test_farm_placements_equal_the_jax_farm(tiny_lm, policy):
    """The traffic mix's requests submitted to both farms, a replica drained
    and undrained half way: the same rids, i.e. the same placements."""
    jcfg, tcfg, jparams, _ = tiny_lm
    jfarm = JFarm(jcfg, jparams, n_replicas=3, policy=policy, max_batch=2, max_seq=48)
    tfarm = _farm(tiny_lm, n_replicas=3, policy=policy, max_batch=2, max_seq=48)
    arrivals = SHORT_LONG.sample_arrivals(tcfg.vocab_size)
    rids = {"jax": [], "port": []}
    for k, (_, cls, prompt) in enumerate(arrivals):
        if k == 4:
            jfarm.drain(1), tfarm.drain(1)
        if k == 8:
            jfarm.undrain(1), tfarm.undrain(1)
        for name, farm in (("jax", jfarm), ("port", tfarm)):
            rids[name].append(farm.submit(prompt, max_new_tokens=cls.max_new_tokens))
        if k % 3 == 2:  # some service between submissions: least_loaded sees it
            jfarm.step(), tfarm.step()
    assert rids["port"] == rids["jax"]
    assert {tfarm.replica_of(r) for r in rids["port"]} == {0, 1, 2}
    assert [r.rid for r in tfarm.run_until_done()] == sorted(rids["port"])


def test_refresh_drops_the_refreshed_replicas_graph_only(tiny_lm, tmp_path):
    mode = CrossbarMode(enabled=True, device=DeviceConfig(**DRIFTING))
    farm = _farm(tiny_lm, n_replicas=2, max_batch=2, max_seq=32, crossbar=mode)
    for k in range(2):
        farm.submit(_prompt(5, lo=k), max_new_tokens=6)
    farm.step()
    g0, g1 = (eng.runner.decode_graph for eng in farm.replicas)
    assert g0 is not None and g1 is not None
    farm.refresh(0)
    assert farm.replicas[0].runner.decode_graph is None
    assert farm.replicas[1].runner.decode_graph is g1
    farm.step()
    assert farm.replicas[0].runner.decode_graph not in (None, g0)
    assert farm.replicas[1].runner.decode_graph is g1
    farm.replicas[1].save_artifacts(str(tmp_path))
    farm.hot_swap(1, str(tmp_path))
    assert farm.replicas[1].runner.decode_graph is None
    assert farm.replicas[0].runner.decode_graph is not None
    assert all(len(r.generated) == 6 for r in farm.run_until_done())
