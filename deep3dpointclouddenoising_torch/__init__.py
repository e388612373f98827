"""PyTorch/CUDA port of the point-cloud denoiser.

The JAX package ``deep3dpointclouddenoising_tpu`` is the reference; this
package keeps its module names and its channels-last ``(B, N, C)`` layout,
and imports nothing of it.  The KPConv aggregation runs as a hand-written
CUDA kernel (``csrc/kpconv_fwd.cu``) on the card.

Distance terms feed a square root near zero, so float32 matrix products
and convolutions must not drop to TF32 on the card.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
