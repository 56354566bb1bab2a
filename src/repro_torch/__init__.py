"""PyTorch/CUDA port of the Newton crossbar reproduction.

Mirrors ``repro`` module for module (``repro_torch.core.crossbar`` is the
counterpart of ``repro.core.crossbar``), imports ``torch`` and never ``jax``
or ``repro``.  Params are plain nested dicts of tensors whose joined key
paths are the programmed-artifact names; every entry point that allocates
takes ``device=`` (default ``"cuda"``) and raises without a card rather than
carrying on on the CPU.
"""
