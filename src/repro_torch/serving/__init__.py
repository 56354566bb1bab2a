from repro_torch.serving.engine import ModelRunner, Request, ServingEngine  # noqa: F401
