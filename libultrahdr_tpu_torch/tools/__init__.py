"""Hardening gates of the port: ``sanitize_replay`` (ASan/UBSan over the
host C++ and the C-ABI shim, on the CPU) and ``sanitize_kernels`` (every
CUDA kernel against its plain version, for compute-sanitizer on the
card)."""
