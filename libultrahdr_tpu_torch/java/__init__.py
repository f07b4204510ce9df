"""The port's Java binding: the ``com.google.media.codecs.ultrahdr``
classes, their JNI shim ``jni/uhdr_jni.cpp`` over the port's C ABI, and
``build`` (``python -m libultrahdr_tpu_torch.java.build``)."""
