"""Helpers shared by the port's MoE serving tests: carrying a JAX config and
params across, a fresh JAX engine over a compiled runner, and greedy-token
identity held only where no decision is a coin toss."""
import copy
import dataclasses
import itertools

import numpy as np
import jax
import jax.numpy as jnp

from repro.models import model as JM
from repro_torch.configs import ModelConfig, StageSpec
from repro_torch.convert import params_from_numpy


def port_config(jcfg) -> ModelConfig:
    fields = dataclasses.asdict(jcfg)
    fields["stages"] = tuple(StageSpec(**s) for s in fields["stages"])
    return ModelConfig(**fields)


def carry(jcfg):
    jparams, _ = JM.init_model(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def fresh_engine(eng):
    """A copy of a JAX engine with a new scheduler state over the same
    runner (its jitted prefill and decode compile once for the module)."""
    eng = copy.copy(eng)
    eng.cache = eng.runner.init_cache(eng.max_batch)
    eng.slots = [None] * eng.max_batch
    eng.pos = np.zeros(eng.max_batch, np.int32)
    eng.last_tok = np.zeros(eng.max_batch, np.int32)
    eng.pending, eng._completed, eng._rid = [], {}, itertools.count(0)
    return eng


def spy_ticks(eng):
    """Record the active slots' logits at every decode tick and, for a
    recurrent model, the logits of every prefill, which sample its first
    token (told apart by the call: a sample inside ``admit_slot``)."""
    ticks, admitting = [], []
    real_sample, real_admit = eng.runner.sample, eng.runner.admit_slot

    def admit_slot(*args, **kwargs):
        admitting.append(True)
        try:
            return real_admit(*args, **kwargs)
        finally:
            admitting.pop()

    def sample(logits):
        if admitting:
            ticks.append(np.array(logits))
        else:
            active = [i for i, s in enumerate(eng.slots) if s is not None]
            ticks.append(np.array(logits[active]))
        return real_sample(logits)

    eng.runner.admit_slot, eng.runner.sample = admit_slot, sample
    return ticks


def same_tokens(je, te, vocab, seed):
    """Serve the seed's prompts on both engines; identity is asserted where
    no decision is a coin toss: at every tick the top-2 margin (in both)
    exceeds twice the largest logit difference between them."""
    jt, tt = spy_ticks(je), spy_ticks(te)
    rng = np.random.default_rng(seed)
    for p in [rng.integers(0, vocab, size=int(rng.integers(5, 20))) for _ in range(2)]:
        assert je.submit(p, max_new_tokens=6) == te.submit(p, max_new_tokens=6)
    jtok = [r.generated for r in je.run_until_done()]
    ttok = [r.generated for r in te.run_until_done()]
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        gap = np.abs(a - b).max()
        top_a, top_b = np.sort(a, axis=-1), np.sort(b, axis=-1)
        margin = min((top_a[:, -1] - top_a[:, -2]).min(), (top_b[:, -1] - top_b[:, -2]).min())
        assert margin > 2 * gap, (margin, gap)
    assert ttok == jtok and all(len(t) == 6 for t in ttok)
    return ttok
