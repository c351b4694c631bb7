from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    init,
    schedule,
)
from repro_torch.optim.compression import (
    Compressed,
    compress_with_feedback,
    decompress,
    init_error,
)

__all__ = [
    "AdamWConfig", "AdamWState", "apply_updates", "clip_by_global_norm",
    "global_norm", "init", "schedule",
    "Compressed", "compress_with_feedback", "decompress", "init_error",
]
