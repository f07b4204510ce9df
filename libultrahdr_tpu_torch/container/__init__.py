"""Container & metadata layer (host-side, byte-exact): copies of the JAX
package's ICC, ISO 21496-1, XMP, MPF and JPEG_R container writers."""

from . import icc, iso21496, jpegr_container, mpf, xmp  # noqa: F401
