"""ssvio_tpu_torch — the stereo visual SLAM engine of `ssvio_tpu`, in PyTorch.

A port of the JAX package `ssvio_tpu` to PyTorch and CUDA for one NVIDIA
Hopper GPU. The JAX package stays the reference: every module here mirrors
its counterpart's name (`ssvio_tpu_torch/ops/lk.py` <-> `ssvio_tpu/ops/lk.py`)
and is held against it by the `tests/test_torch_*.py` parity tests. This
package imports neither jax nor `ssvio_tpu`; it needs torch and numpy only.

Idiom:
- Plain functions on tensors. `System` carries an explicit `device`, and
  every tensor it creates lives there.
- The SLAM state (`FeatState`, `MapState`, `LocalBAProblem`) stays a
  NamedTuple of tensors, as in the JAX package. It holds no trainable
  parameters, so nothing here is an `nn.Module`, and no autograd graph is
  ever built (the entry points run under `torch.no_grad`).
- Each Pallas kernel of the JAX package becomes a hand-written CUDA kernel
  (`csrc/`), bound through a ctypes wrapper that also holds the kernel's
  plain torch version (`ops/lk_cuda.py`).
- The loop-closing ops are plain tensor code, as they are in the JAX
  package: `ops/orb.py` (descriptors as int32 bits, popcount Hamming),
  `ops/bow.py` (vocabulary tree), `ops/pnp.py` (batched RANSAC),
  `ops/pgo.py` (pose graph), and `loopclosing.py::loop_describe`.

Conventions (as `ssvio_tpu/__init__.py` documents them):
- Pose `T_cw`: maps world points into the camera frame; a [3, 4] float32
  tensor `[R | t]`. Trajectories are exported as `T_wc`.
- se3 twists are ordered `[rho(3), phi(3)]`, with LEFT-multiplicative
  updates `T <- Exp(xi) @ T`.
- Images are float32 grayscale `[H, W]` in [0, 255]; keypoints are (x, y).
"""

__version__ = "0.1.0"

import torch as _torch

# The BA normal equations and pose chains are float32 einsums and small
# solves; TF32 (about three decimal digits) there changes the answers.
# Pin full float32 for matmuls and for cuDNN, as the JAX package pins
# `jax_default_matmul_precision=highest`.
_torch.set_float32_matmul_precision("highest")
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from ssvio_tpu_torch.config import Settings  # noqa: E402,F401
