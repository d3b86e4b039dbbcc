"""somar_tpu_torch — the PyTorch + CUDA port of somar_tpu.

The package mirrors somar_tpu's layout and conventions so that each module
can be held array-to-array against its JAX counterpart:

  * arrays are vertical-major ([z, y, x]); logical direction d (0=x, 1=y,
    2=z, vertical = ndim-1) maps to array axis ndim-1-d;
  * advection arrays are padded (ADVECT_GROW = 4 ghost layers) and
    face-indexed (entry f is the face between cells f and f+1);
  * float32 by default, float64 when NSParams.dtype is torch.float64.

Plain tensor code is PyTorch; the Pallas TPU kernels of somar_tpu become
hand-written CUDA kernels for Hopper (csrc/), built with nvcc at first use
and bound with ctypes.  This package never imports jax or somar_tpu.
"""

__version__ = "0.1.0"
