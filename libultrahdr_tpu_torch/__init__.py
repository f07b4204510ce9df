"""libultrahdr_tpu_torch -- the PyTorch/CUDA port of libultrahdr_tpu.

A second package beside the JAX one, which stays the reference: the same
Ultra HDR (gain map) codec on an NVIDIA H100, with plain tensor code in
PyTorch and every TPU kernel on a ported path rewritten by hand for Hopper
(``csrc/``).  It imports torch and numpy, never jax and nothing under
``libultrahdr_tpu``; the native host C++ of the JAX package is compiled by
path (``jpeg/native.py``).  Ported so far: the API-0 P010 encode
(``UhdrEncoder(device=...)``) and the fused JPEG_R decode to HLG, PQ or
LINEAR output (``UhdrDecoder(device=...)``, ``JpegR.decode``,
``JpegR.decode_to_device``); ROADMAP.md lists the slices still to come.

The tensor math runs in full float32: TF32 matrix products and convolutions
are turned off here, because the JAX package runs its DCT at HIGHEST
precision.
"""

__version__ = "1.4.0"  # the reference's UHDR_LIB_VERSION, as in libultrahdr_tpu

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .errors import UhdrError, UhdrErrorCode  # noqa: E402,F401
from .types import (ColorGamut, ColorRange, ColorTransfer,  # noqa: E402,F401
                    GainMapMetadata, ImgFmt, ImgLabel, RawImage)
from .api import UhdrDecoder, UhdrEncoder  # noqa: E402,F401
from .jpegr import JpegR  # noqa: E402,F401
