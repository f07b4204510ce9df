"""The K-batch stitch of the pipelined encode: k images' packed words laid
back to back in one buffer.

The JAX package stitches with XLA ops (``libultrahdr_tpu/fused.py``
``_stitch_image_streams``: one ``dynamic_update_slice`` an image, each at
the sum of the earlier images' live word counts); no Pallas kernel.  As the
other kernels of the port:

- a plain PyTorch version (``stitch_plain``), which the CPU route runs and
  the CPU tests hold against a numpy model, and ``chip_smoke.py`` holds the
  kernel against on the card (``torch.equal`` on the live words);
- the wrapper of the hand-written CUDA kernel ``csrc/stitch_kernel.cu``
  (its header gives the design and what bounds it on the H100), built with
  nvcc for sm_90a at first use into ``_build/``, launched on PyTorch's
  current stream, raising on a refused launch, counting its launches
  (``STITCH_KERNEL.launches``);
- a dispatcher (``stitch``): a CPU tensor goes to the plain version, a
  CUDA tensor to the kernel, anything else raises.

Inputs: ``room`` (k, pitch) int32 with contiguous rows, row i holding image
i's words (u32 patterns); ``counts`` (k,) int64, any stride (the pack
kernel's per-image scratch rows hold each image's live word count at [1]),
each clamped to [0, pitch].  Output: (k * pitch,) int32 whose first
sum(counts) words are the rows' live prefixes in row order; the words
after them are unspecified (the kernel leaves them as they were, the plain
version writes zeros).
"""

from __future__ import annotations

import ctypes

import torch

from .._buildlib import CudaLibrary, check_launch
from ..errors import unsupported

# images a launch takes (csrc/stitch_kernel.cu kMaxImages: the prefix of
# their counts sits in shared memory)
MAX_IMAGES = 1024


def stitch_plain(room: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (any device): the rows' live prefixes
    concatenated at the front of a zeroed (k * pitch,) buffer."""
    k, pitch = room.shape
    out = torch.zeros(k * pitch, dtype=torch.int32, device=room.device)
    live = torch.clamp(counts.to(torch.int64), 0, pitch).tolist()
    if sum(live):
        out[:sum(live)] = torch.cat([room[i, :c] for i, c in enumerate(live)])
    return out


_PTR, _I64 = ctypes.c_void_p, ctypes.c_int64
STITCH_LIB = CudaLibrary("stitch_kernel", {
    "uhdr_stitch": [_PTR, _I64, _PTR, _I64, ctypes.c_int, _PTR, _PTR]})


class _StitchKernel:
    """Wrapper of uhdr_stitch: checks, launch, launch count."""

    def __init__(self):
        self.launches = 0

    @staticmethod
    def check(room: torch.Tensor, counts: torch.Tensor, out: torch.Tensor):
        """Raise unless the inputs are what the kernel reads."""
        dev = room.device
        if dev.type != "cuda":
            raise ValueError(f"stitch kernel needs CUDA tensors, got {dev}")
        if room.dim() != 2 or room.dtype != torch.int32 \
                or room.stride(1) != 1 or room.stride(0) < room.shape[1]:
            raise ValueError(f"stitch kernel: room must be a (k, pitch) int32 "
                             f"tensor with contiguous rows, got {room.dtype} "
                             f"{tuple(room.shape)} strides {room.stride()}")
        k, pitch = room.shape
        if not 1 <= k <= MAX_IMAGES:
            raise ValueError(f"stitch kernel: {k} images, at most "
                             f"{MAX_IMAGES}")
        if counts.device != dev or counts.dtype != torch.int64 \
                or tuple(counts.shape) != (k,) or counts.stride(0) < 1:
            raise ValueError(f"stitch kernel: counts must be a ({k},) int64 "
                             f"tensor on {dev}, got {counts.dtype} "
                             f"{tuple(counts.shape)} on {counts.device}")
        if out.device != dev or out.dtype != torch.int32 \
                or not out.is_contiguous() or out.numel() < k * pitch:
            raise ValueError(f"stitch kernel: out must be a contiguous int32 "
                             f"tensor of at least {k * pitch} words on {dev}")
        if out.data_ptr() % 16:
            raise ValueError("stitch kernel: out must be 16-byte aligned")

    def launch(self, room: torch.Tensor, counts: torch.Tensor,
               out: torch.Tensor):
        """The kernel alone on checked inputs."""
        lib = STITCH_LIB.build()
        dev = room.device
        check_launch(lib, lib.uhdr_stitch(
            room.data_ptr(), room.stride(0), counts.data_ptr(),
            counts.stride(0), room.shape[0], out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "uhdr_stitch")
        self.launches += 1

    def __call__(self, room: torch.Tensor, counts: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
        if out is None:
            out = torch.empty(room.shape[0] * room.shape[1],
                              dtype=torch.int32, device=room.device)
        self.check(room, counts, out)
        self.launch(room, counts, out)
        return out


STITCH_KERNEL = _StitchKernel()


def stitch(room: torch.Tensor, counts: torch.Tensor,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """Dispatcher: plain version for CPU tensors (`out` unused), the CUDA
    kernel for CUDA tensors (into `out` when given).  No fallback."""
    if room.device.type == "cpu":
        return stitch_plain(room, counts)
    if room.device.type == "cuda":
        return STITCH_KERNEL(room, counts, out)
    raise unsupported(f"no stitch implementation for device {room.device}")
