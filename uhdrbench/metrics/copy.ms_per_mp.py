"""Upload and download (``fused.upload_planes``, ``ops/pixel.pinned``, the
``.cpu()`` downloads): milliseconds of memcpy on the card per megapixel,
from the trace's copy operations."""


def read(tr):
    copies = [o for o in tr.device_ops if o.cat == "gpu_memcpy"]
    if not copies or not tr.megapixels:
        return None
    return 1e3 * sum(o.seconds for o in copies) / tr.megapixels
