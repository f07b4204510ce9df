"""The port's C ABI: ``ultrahdr_tpu.h``, its shim ``uhdr_capi.cpp`` (an
embedded interpreter over ``libultrahdr_tpu_torch.capi_bridge``), the C
programs on it, ``build`` (``python -m libultrahdr_tpu_torch.capi.build``)
and ``abi`` (ctypes mirrors of the ABI's structs)."""
