"""Device dispatch (``fused.py``, ``jpegr.py``): CUDA kernels launched per
image, every kernel of the traced run over the requests it completed."""


def read(tr):
    n = sum(1 for o in tr.device_ops if o.cat == "kernel")
    if not n or not tr.requests:
        return None
    return n / len(tr.requests)
