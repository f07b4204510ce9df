"""Baseline JPEG encode pieces of the port: tables, DCT, the device Huffman
pack and its kernel, header assembly, and the shared native C++ bindings."""
