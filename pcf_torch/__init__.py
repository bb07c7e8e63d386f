"""pcf_torch: PointConvFormer in PyTorch with hand-written CUDA kernels for
Hopper, ported from pcf_tpu (JAX on a TPU), which stays the reference.

File names mirror pcf_tpu: pcf_torch/x/y.py ports pcf_tpu/x/y.py. The
package imports torch, numpy and scipy, never jax, flax or pcf_tpu.
"""

import torch

# f32 means f32: no TF32 rounding in float32 matmuls or convolutions, so the
# port's f32 numbers are comparable with pcf_tpu's HIGHEST-precision paths.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device`, "cuda" when it is None;
    a CUDA device raises when CUDA is absent (pass device="cpu" to run on the
    CPU)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "pcf_torch on the CPU")
    return device
