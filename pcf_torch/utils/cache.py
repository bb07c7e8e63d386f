"""Build ahead of the first step, the port's counterpart of pcf_tpu's
persistent compilation cache (pcf_tpu/utils/cache.py).

pcf_tpu keeps XLA's compiled programs on disk, so that a restart skips the
first compile of its steps. The port compiles nothing per step: a step is
captured as a CUDA graph at its first call (parallel/graphs.py), which takes
a moment. What costs time is building the hand-written kernels (one nvcc per
source of pcf_torch/csrc, the longest part of a cold start) and the native
library (g++). Both are built at first use into pcf_torch/_build/,
under names that carry a hash of their source and flags, and loaded from
there by every later process. enable_compile_cache builds (or loads) them
before the first step, so that no step carries a build.

cfg.compile_cache_dir is not read: it names JAX's cache, outside the
checkout, and the kernels' loaders look for their libraries in
pcf_torch/_build/ only. A build that fails raises; nothing falls back.
"""

from __future__ import annotations

import torch


def enable_compile_cache(device) -> dict:
    """Build or load the native library (where the pipeline takes it:
    data/pyramid.use_native) and, for a CUDA `device`, every CUDA kernel.
    Returns {"native": whether the pipeline takes the native library,
    "kernels": the kernel sources loaded}."""
    from pcf_torch.data.pyramid import use_native
    from pcf_torch.ops.kernels import build as kbuild

    native = use_native()
    kernels = []
    if torch.device(device).type == "cuda":
        kbuild.build()
        for name in kbuild.SOURCES:
            kbuild.load(name)
            kernels.append(name)
    return {"native": native, "kernels": kernels}
