"""tsar-mvs-tpu ported to PyTorch with hand-written CUDA kernels for Hopper.

The JAX package ``tsar_mvs_tpu`` is the reference; this package keeps its
module names so each counterpart is found by path. It imports torch,
never jax, and nothing of ``tsar_mvs_tpu``: ``config``, ``eval``,
``models/weak_texture`` and ``utils/*`` are its own copies of the JAX
package's host-side modules (``convert`` carries parameter objects and
state across for the tests that compare the two).

The two TPU kernels become CUDA C++ under ``csrc/``: the s-volume NCC cost
(``ops/cuda_ncc.py``) and the s-volume build (``ops/cuda_warp.py``). They
are compiled for ``sm_90a`` with nvcc on first use (``_build.py``), as
is kernel B3 (``ops/cuda_direct.py``), the direct sampler's cost.
``parallel/`` splits a scene's reference views over the ranks of a
torch.distributed group.
"""

import torch

# The RANSAC and geometry products must stay full float32 on the card:
# TF32 keeps about three decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
