"""libultrahdr_tpu_torch -- the PyTorch/CUDA port of libultrahdr_tpu.

A second package beside the JAX one, which stays the reference: the same
Ultra HDR (gain map) codec on an NVIDIA H100, with plain tensor code in
PyTorch and every TPU kernel on a ported path rewritten by hand for Hopper
(``csrc/``).  It imports torch and numpy, never jax and nothing under
``libultrahdr_tpu``; it keeps its own copy of the JAX package's native host
C++ (``csrc/host/``, bound in ``jpeg/native.py``).  Ported so far: the
API-0..4 encodes (``UhdrEncoder(device=...)``, ``JpegR.encode_api0`` ..
``encode_api4``) and the throughput-mode API-0 P010 encode
(``fused.encode_api0_p010_pipelined``); the JPEG_R decode to HLG, PQ or
LINEAR output on the fused route and on the general path (progressive and
grayscale streams, fractional and resized gain maps) and the SRGB /
RGBA8888 output (``UhdrDecoder(device=...)``, ``JpegR.decode``), the native
host decode engine (``JpegR.decode_host``), the device-resident decode per
image, batched and microbatched (``JpegR.decode_to_device``,
``decode_to_device_batch``, with effects on the device), the effect queue
and ``enable_gpu_acceleration`` of both, ``is_uhdr_image``, the SMPTE
2094-50 gain map (``agtm``), the legacy JPEGR surface (``jpegr_compat``),
the ``ultrahdr_app`` analog (``cli``), the C-ABI marshaling layer
(``capi_bridge``) and the stage timers (``utils``); ROADMAP.md lists what
is still to come (the batch over several GPUs).

The tensor math runs in full float32: TF32 matrix products and convolutions
are turned off here, because the JAX package runs its DCT at HIGHEST
precision.  On the CPU, the vector math library that PyTorch links (MKL's
VML: ``torch.exp``, ``log`` and the like) chooses its code path at its first
call, and a first call made from several threads at once can run a share of
the elements on another path, with other rounding: two encodes started
together on fresh threads then wrote different bytes.  One call here, while
the package is imported, makes that choice before any caller's thread runs.
"""

__version__ = "1.4.0"  # the reference's UHDR_LIB_VERSION, as in libultrahdr_tpu

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.exp(torch.zeros(1))

from .errors import UhdrError, UhdrErrorCode  # noqa: E402,F401
from .types import (Codec, ColorGamut, ColorRange,  # noqa: E402,F401
                    ColorTransfer, CompressedImage, EncPreset,
                    GainMapMetadata, ImgFmt, ImgLabel, MirrorDirection,
                    RawImage, alloc_raw_image)
from .api import (UhdrDecoder, UhdrEncoder,  # noqa: E402,F401
                  validate_gainmap_metadata)
from .jpegr import JpegR, is_uhdr_image  # noqa: E402,F401
