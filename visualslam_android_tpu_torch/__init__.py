"""PyTorch + CUDA port of the PTAM-class monocular SLAM engine.

This package runs the per-frame tracking step (``models/frame_step.py``),
the stereo bootstrap that builds the first map (``models/bootstrap.py``)
and the bundle adjustment and epipolar map growth it uses
(``models/bundle.py``, ``models/mapmaker.py``) on an NVIDIA GPU. It mirrors
the module layout of the JAX package ``visualslam_android_tpu`` (``ops/``,
``models/``, ``utils/``), which stays beside it as the reference the port
is tested against. It never imports jax or the JAX package. State
constructors build on the CUDA card unless the caller names a device
(``utils/tensors.default_device``); functions follow their inputs' device.

Plain tensor code is PyTorch; the FAST segment test and the keyframe's
fused rescore + non-max suppression are CUDA kernels written by hand for
Hopper (``csrc/fast.cu``, built with nvcc on first use into ``_build/``).
On CPU tensors every wrapper runs its plain PyTorch version instead, which
is what the CPU tests exercise.
"""

import torch as _torch

# Geometry and matching need true f32 products. The ZMSSD cross term is a
# grouped convolution that the JAX package runs at Precision.HIGHEST
# (ops/match.py); cuDNN would run it in TF32 by default, which keeps about
# three decimal digits and moves argmin ties. Matmuls are f32 by default,
# but say so explicitly, as the JAX package sets
# jax_default_matmul_precision="highest".
_torch.backends.cudnn.allow_tf32 = False
_torch.backends.cuda.matmul.allow_tf32 = False

from visualslam_android_tpu_torch.config import SLAMConfig  # noqa: E402

__version__ = "0.1.0"
__all__ = ["SLAMConfig", "__version__"]
