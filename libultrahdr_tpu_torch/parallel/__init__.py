"""Batch data parallelism and spatial sharding over a mesh of devices.

Port of ``libultrahdr_tpu/parallel``: the reference's 4-thread row work
queue (jpegr.cpp:68-133, 732) becomes one eager pipeline per image on its
device, a loop over an image batch on one device, and a ("data", "spatial")
``Mesh`` of torch devices driven by one process: batches spread over
"data" for throughput, an image's rows over "spatial" for latency, with
copies between devices in place of JAX's collectives (``batch.py``).
"""

from .batch import (encode_core_p010, encode_core_p010_twopass,  # noqa: F401
                    encode_batch_p010, make_mesh, sharded_encode_step,
                    sharded_apply_step)
