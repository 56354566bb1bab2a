from repro_torch.data.pipeline import (  # noqa: F401
    SyntheticLMDataset,
    MemmapLMDataset,
    EmbeddingStubDataset,
    make_dataset,
    prefetch,
)
