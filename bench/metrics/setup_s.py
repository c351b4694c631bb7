"""Set-up time, in s: from the process's start to the window's start
(imports, the CUDA context, the kernel's build or load, the normalizer's
fit, the warm call)."""


def read(reading):
    return reading.get("setup_s")
