"""Baseline JPEG encode pieces of the port: tables, DCT, the device Huffman
pack and its kernel, header assembly, and the host native C++ bindings.

The package re-exports the JAX package's ``libultrahdr_tpu.jpeg`` names,
bound to the port's own decoder and encoder."""

from .decoder import JpegInfo, decode_to_planes, decode_to_rgba, parse_jpeg  # noqa: F401
from .encoder import JpegEncoder  # noqa: F401
