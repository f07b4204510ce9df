/*
 * UltraHDRDecoder — Java projection of the decoder half of the C ABI
 * (libultrahdr_tpu_torch/capi/ultrahdr_tpu.h), API-compatible with the
 * reference binding (java/com/google/media/codecs/ultrahdr/
 * UltraHDRDecoder.java:35-470): the same GainMapMetadata and
 * RawImage{,8,32,64} result classes, static isUHDRImage, probe getters and
 * decode lifecycle.  getDecodedImageNative returns the packed pixel bytes
 * in native order and fills the img* fields; the typed int[]/long[] views
 * are materialized lazily on the Java side.
 */
package com.google.media.codecs.ultrahdr;

import static com.google.media.codecs.ultrahdr.UltraHDRCommon.*;

import java.io.IOException;
import java.nio.ByteBuffer;
import java.nio.ByteOrder;
import java.util.Arrays;

public class UltraHDRDecoder implements AutoCloseable {

    /** Gain map metadata (uhdr_gainmap_metadata_t). */
    public static class GainMapMetadata {
        public float[] maxContentBoost = new float[3];
        public float[] minContentBoost = new float[3];
        public float[] gamma = new float[3];
        public float[] offsetSdr = new float[3];
        public float[] offsetHdr = new float[3];
        public float hdrCapacityMin;
        public float hdrCapacityMax;
        public boolean useBaseColorSpace;

        public GainMapMetadata() {
            Arrays.fill(this.maxContentBoost, 1.0f);
            Arrays.fill(this.minContentBoost, 1.0f);
            Arrays.fill(this.gamma, 1.0f);
            Arrays.fill(this.offsetSdr, 0.0f);
            Arrays.fill(this.offsetHdr, 0.0f);
            this.hdrCapacityMin = 1.0f;
            this.hdrCapacityMax = 1.0f;
            this.useBaseColorSpace = true;
        }

        public GainMapMetadata(float[] maxContentBoost, float[] minContentBoost, float[] gamma,
                float[] offsetSdr, float[] offsetHdr, float hdrCapacityMin,
                float hdrCapacityMax, boolean useBaseColorSpace) {
            System.arraycopy(maxContentBoost, 0, this.maxContentBoost, 0, 3);
            System.arraycopy(minContentBoost, 0, this.minContentBoost, 0, 3);
            System.arraycopy(gamma, 0, this.gamma, 0, 3);
            System.arraycopy(offsetSdr, 0, this.offsetSdr, 0, 3);
            System.arraycopy(offsetHdr, 0, this.offsetHdr, 0, 3);
            this.hdrCapacityMin = hdrCapacityMin;
            this.hdrCapacityMax = hdrCapacityMax;
            this.useBaseColorSpace = useBaseColorSpace;
        }
    }

    /** Raw pixel descriptor; subclasses carry a typed view of the buffer. */
    public static abstract class RawImage {
        public byte[] nativeOrderBuffer;
        public int fmt;
        public int cg;
        public int ct;
        public int range;
        public int w;
        public int h;
        public int stride;

        public RawImage(byte[] nativeOrderBuffer, int fmt, int cg, int ct, int range, int w,
                int h, int stride) {
            this.nativeOrderBuffer = nativeOrderBuffer;
            this.fmt = fmt;
            this.cg = cg;
            this.ct = ct;
            this.range = range;
            this.w = w;
            this.h = h;
            this.stride = stride;
        }
    }

    public static class RawImage32 extends RawImage {
        public int[] data;

        public RawImage32(byte[] nativeOrderBuffer, int fmt, int cg, int ct, int range, int w,
                int h, int[] data, int stride) {
            super(nativeOrderBuffer, fmt, cg, ct, range, w, h, stride);
            this.data = data;
        }
    }

    public static class RawImage8 extends RawImage {
        public byte[] data;

        public RawImage8(byte[] nativeOrderBuffer, int fmt, int cg, int ct, int range, int w,
                int h, byte[] data, int stride) {
            super(nativeOrderBuffer, fmt, cg, ct, range, w, h, stride);
            this.data = data;
        }
    }

    public static class RawImage64 extends RawImage {
        public long[] data;

        public RawImage64(byte[] nativeOrderBuffer, int fmt, int cg, int ct, int range, int w,
                int h, long[] data, int stride) {
            super(nativeOrderBuffer, fmt, cg, ct, range, w, h, stride);
            this.data = data;
        }
    }

    static {
        System.loadLibrary("uhdr_tpu_torch_jni");
    }

    private long handle;

    private byte[] decodedDataNativeOrder;
    private int[] decodedDataInt32;
    private long[] decodedDataInt64;
    private int imgWidth = -1, imgHeight = -1, imgStride = 0;
    private int imgFormat = UHDR_IMG_FMT_UNSPECIFIED;
    private int imgGamut = UHDR_CG_UNSPECIFIED;
    private int imgTransfer = UHDR_CT_UNSPECIFIED;
    private int imgRange = UHDR_CR_UNSPECIFIED;

    private byte[] decodedGainMapDataNativeOrder;
    private int[] decodedGainMapDataInt32;
    private int gainmapWidth = -1, gainmapHeight = -1, gainmapStride = 0;
    private int gainmapFormat = UHDR_IMG_FMT_UNSPECIFIED;

    /** True when the stream parses as a JPEG_R (ultra hdr) image. */
    public static boolean isUHDRImage(byte[] data, int size) throws IOException {
        if (data == null) {
            throw new IOException("received null for image data handle");
        }
        if (size <= 0) {
            throw new IOException("invalid image size");
        }
        return isUHDRImageNative(data, size) == 1;
    }

    public UltraHDRDecoder() throws IOException {
        handle = 0;
        init();
        resetState();
    }

    @Override
    public void close() throws Exception {
        destroy();
    }

    public void setCompressedImage(byte[] data, int size, int colorGamut, int colorTransfer,
            int range) throws IOException {
        if (data == null) {
            throw new IOException("received null for image data handle");
        }
        if (size <= 0) {
            throw new IOException("invalid image size");
        }
        setCompressedImageNative(data, size, colorGamut, colorTransfer, range);
    }

    public void setOutputFormat(int fmt) throws IOException {
        setOutputFormatNative(fmt);
    }

    public void setColorTransfer(int ct) throws IOException {
        setColorTransferNative(ct);
    }

    public void setMaxDisplayBoost(float displayBoost) throws IOException {
        setMaxDisplayBoostNative(displayBoost);
    }

    public void enableGpuAcceleration(int enable) throws IOException {
        enableGpuAccelerationNative(enable);
    }

    /** Parse the stream headers; enables the get* accessors. */
    public void probe() throws IOException {
        probeNative();
    }

    public int getImageWidth() throws IOException {
        return getImageWidthNative();
    }

    public int getImageHeight() throws IOException {
        return getImageHeightNative();
    }

    public int getGainMapWidth() throws IOException {
        return getGainMapWidthNative();
    }

    public int getGainMapHeight() throws IOException {
        return getGainMapHeightNative();
    }

    public byte[] getExif() throws IOException {
        return getExifNative();
    }

    public byte[] getIcc() throws IOException {
        return getIccNative();
    }

    public byte[] getBaseImage() throws IOException {
        return getBaseImageNative();
    }

    public byte[] getGainMapImage() throws IOException {
        return getGainMapImageNative();
    }

    public GainMapMetadata getGainmapMetadata() throws IOException {
        float[] flat = getGainmapMetadataNative();
        if (flat == null || flat.length != 18) {
            throw new IOException("gainmap metadata unavailable; call probe() first");
        }
        return new GainMapMetadata(
                Arrays.copyOfRange(flat, 0, 3), Arrays.copyOfRange(flat, 3, 6),
                Arrays.copyOfRange(flat, 6, 9), Arrays.copyOfRange(flat, 9, 12),
                Arrays.copyOfRange(flat, 12, 15), flat[15], flat[16], flat[17] != 0.0f);
    }

    /** Decode the stream into the configured output format. */
    public void decode() throws IOException {
        decodeNative();
    }

    /** Decoded display image; valid after {@link #decode()}. */
    public RawImage getDecodedImage() throws IOException {
        if (decodedDataNativeOrder == null) {
            decodedDataNativeOrder = getDecodedImageNative();
        }
        if (imgFormat == UHDR_IMG_FMT_64bppRGBAHalfFloat) {
            if (decodedDataInt64 == null) {
                ByteBuffer data = ByteBuffer.wrap(decodedDataNativeOrder);
                data.order(ByteOrder.nativeOrder());
                decodedDataInt64 = new long[imgWidth * imgHeight];
                data.asLongBuffer().get(decodedDataInt64);
            }
            return new RawImage64(decodedDataNativeOrder, imgFormat, imgGamut, imgTransfer,
                    imgRange, imgWidth, imgHeight, decodedDataInt64, imgStride);
        }
        if (imgFormat == UHDR_IMG_FMT_32bppRGBA8888
                || imgFormat == UHDR_IMG_FMT_32bppRGBA1010102) {
            if (decodedDataInt32 == null) {
                ByteBuffer data = ByteBuffer.wrap(decodedDataNativeOrder);
                data.order(ByteOrder.nativeOrder());
                decodedDataInt32 = new int[imgWidth * imgHeight];
                data.asIntBuffer().get(decodedDataInt32);
            }
            return new RawImage32(decodedDataNativeOrder, imgFormat, imgGamut, imgTransfer,
                    imgRange, imgWidth, imgHeight, decodedDataInt32, imgStride);
        }
        return null;
    }

    /** Decoded gain map plane(s); valid after {@link #decode()}. */
    public RawImage getDecodedGainMapImage() throws IOException {
        if (decodedGainMapDataNativeOrder == null) {
            decodedGainMapDataNativeOrder = getDecodedGainMapImageNative();
        }
        if (gainmapFormat == UHDR_IMG_FMT_8bppYCbCr400) {
            return new RawImage8(decodedGainMapDataNativeOrder, gainmapFormat,
                    UHDR_CG_UNSPECIFIED, UHDR_CT_UNSPECIFIED, UHDR_CR_UNSPECIFIED,
                    gainmapWidth, gainmapHeight, decodedGainMapDataNativeOrder, gainmapStride);
        }
        if (gainmapFormat == UHDR_IMG_FMT_32bppRGBA8888) {
            if (decodedGainMapDataInt32 == null) {
                ByteBuffer data = ByteBuffer.wrap(decodedGainMapDataNativeOrder);
                data.order(ByteOrder.nativeOrder());
                decodedGainMapDataInt32 = new int[gainmapWidth * gainmapHeight];
                data.asIntBuffer().get(decodedGainMapDataInt32);
            }
            return new RawImage32(decodedGainMapDataNativeOrder, gainmapFormat,
                    UHDR_CG_UNSPECIFIED, UHDR_CT_UNSPECIFIED, UHDR_CR_UNSPECIFIED,
                    gainmapWidth, gainmapHeight, decodedGainMapDataInt32, gainmapStride);
        }
        return null;
    }

    /** Clear all settings and cached results; reusable afterwards. */
    public void reset() throws IOException {
        resetNative();
        resetState();
    }

    private void resetState() {
        decodedDataNativeOrder = null;
        decodedDataInt32 = null;
        decodedDataInt64 = null;
        imgWidth = -1;
        imgHeight = -1;
        imgStride = 0;
        imgFormat = UHDR_IMG_FMT_UNSPECIFIED;
        imgGamut = UHDR_CG_UNSPECIFIED;
        imgTransfer = UHDR_CT_UNSPECIFIED;
        imgRange = UHDR_CR_UNSPECIFIED;

        decodedGainMapDataNativeOrder = null;
        decodedGainMapDataInt32 = null;
        gainmapWidth = -1;
        gainmapHeight = -1;
        gainmapStride = 0;
        gainmapFormat = UHDR_IMG_FMT_UNSPECIFIED;
    }

    private static native int isUHDRImageNative(byte[] data, int size) throws IOException;

    private native void init() throws IOException;

    private native void destroy() throws IOException;

    private native void setCompressedImageNative(byte[] data, int size, int colorGamut,
            int colorTransfer, int range) throws IOException;

    private native void setOutputFormatNative(int fmt) throws IOException;

    private native void setColorTransferNative(int ct) throws IOException;

    private native void setMaxDisplayBoostNative(float displayBoost) throws IOException;

    private native void enableGpuAccelerationNative(int enable) throws IOException;

    private native void probeNative() throws IOException;

    private native int getImageWidthNative() throws IOException;

    private native int getImageHeightNative() throws IOException;

    private native int getGainMapWidthNative() throws IOException;

    private native int getGainMapHeightNative() throws IOException;

    private native byte[] getExifNative() throws IOException;

    private native byte[] getIccNative() throws IOException;

    private native byte[] getBaseImageNative() throws IOException;

    private native byte[] getGainMapImageNative() throws IOException;

    private native float[] getGainmapMetadataNative() throws IOException;

    private native void decodeNative() throws IOException;

    private native byte[] getDecodedImageNative() throws IOException;

    private native byte[] getDecodedGainMapImageNative() throws IOException;

    private native void resetNative() throws IOException;
}
