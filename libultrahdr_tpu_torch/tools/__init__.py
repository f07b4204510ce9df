"""Tools over the port's public API: the hardening gates
(``sanitize_replay``: ASan/UBSan over the host C++ and the C-ABI shim, on
the CPU; ``sanitize_kernels``: every CUDA kernel against its plain version,
for compute-sanitizer on the card), the pipelined encode's wire profile
(``profile_encode_pipeline``), the reference benchmark's matrix and the
headline benchmark (``benchmarks``, ``bench``) and the islow IDCT matrix's
derivation (``derive_islow``)."""
