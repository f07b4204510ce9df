"""Container & metadata layer (host-side, byte-exact): copies of the JAX
package's ICC, ISO 21496-1, XMP, MPF and JPEG_R container writers and of
its Apple EXIF MakerNote headroom reader."""

from . import exif_apple, icc, iso21496, jpegr_container, mpf, xmp  # noqa: F401
