from repro_torch.data.pipeline import (
    DataConfig,
    SyntheticTokenPipeline,
    make_batch_specs,
)

__all__ = ["DataConfig", "SyntheticTokenPipeline", "make_batch_specs"]
