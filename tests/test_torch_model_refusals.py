"""PyTorch port: the model's entry points refuse configs whose blocks are not
ported (an embedding front end) instead of running them wrong, and the training path refuses sLSTM stages.  Each config is the JAX package's reduced
config carried into the port's config class, with the JAX package's
parameter tree carried across through ``params_from_numpy`` (that tree never
passes through the port's ``init_model``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch.configs import ModelConfig, StageSpec, get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import model as TM
from repro_torch.optim import adamw, constant
from repro_torch.train import make_train_step

CASES = {
    "embed_frontend": ("musicgen-large", "front end"),
}


def _port_config(jcfg) -> ModelConfig:
    fields = dataclasses.asdict(jcfg)
    fields["stages"] = tuple(StageSpec(**s) for s in fields["stages"])
    return ModelConfig(**fields)


@pytest.fixture(scope="module", params=sorted(CASES))
def carried(request):
    name, match = CASES[request.param]
    jcfg = jconfigs.reduced(jconfigs.get_config(name))
    jparams, _ = JM.init_model(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tcfg = _port_config(jcfg)
    if tcfg.frontend == "token":
        inp = torch.from_numpy(np.random.default_rng(0).integers(0, tcfg.vocab_size, size=(1, 4)))
    else:
        inp = torch.zeros((1, 4, tcfg.d_model))
    return request.param, tcfg, tparams, inp, match


def test_the_carried_config_is_the_reference_config(carried):
    kind, tcfg, *_ = carried
    assert {
        "embed_frontend": tcfg.frontend == "embed",
    }[kind]


@pytest.mark.parametrize("entry", ["forward", "prefill", "decode_step"])
def test_entry_points_refuse_unported_blocks(carried, entry):
    _, tcfg, tparams, inp, match = carried
    with pytest.raises(NotImplementedError, match=match):
        if entry == "forward":
            TM.forward(tparams, tcfg, inp)
        elif entry == "prefill":
            TM.prefill(tparams, tcfg, inp, None)
        else:
            TM.decode_step(tparams, tcfg, inp[:, :1], torch.tensor(0), None)


@pytest.mark.parametrize("entry", ["init_model", "init_cache"])
def test_init_refuses_unported_blocks(carried, entry):
    _, tcfg, _, _, match = carried
    with pytest.raises(NotImplementedError, match=match):
        if entry == "init_model":
            TM.init_model(tcfg, device="cpu")
        else:
            TM.init_cache(tcfg, 1, 8, device="cpu")


@pytest.mark.parametrize("grad", [True, False])
def test_slstm_training_is_refused(grad):
    """sLSTM stages do not train: on a CUDA tensor the recurrence is the scan
    kernel, whose output has no ``grad_fn``.  ``loss_fn`` (with or without
    grad) and ``make_train_step`` refuse the config on every device; its
    serving forward still runs."""
    tcfg = reduced(get_config("xlstm-350m"))
    assert any("slstm" in s.kinds for s in tcfg.stages)
    params = TM.init_model(tcfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, tcfg.vocab_size, size=(1, 8)))
    with torch.set_grad_enabled(grad), pytest.raises(NotImplementedError, match="sLSTM"):
        TM.loss_fn(params, tcfg, {"inputs": tokens, "targets": tokens})
    with pytest.raises(NotImplementedError, match="sLSTM"):
        make_train_step(tcfg, adamw(constant(1e-3)))
    assert TM.forward(params, tcfg, tokens).shape == (1, 8, tcfg.vocab_size)
