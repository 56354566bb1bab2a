"""PyTorch port: the training path refuses sLSTM stages, whose scan kernel
has no backward, instead of training them without gradients."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import model as TM
from repro_torch.optim import adamw, constant
from repro_torch.train import make_train_step


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
