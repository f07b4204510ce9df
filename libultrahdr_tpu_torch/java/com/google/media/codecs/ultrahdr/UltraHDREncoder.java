/*
 * UltraHDREncoder — Java projection of the encoder half of the C ABI
 * (libultrahdr_tpu_torch/capi/ultrahdr_tpu.h), API-compatible with the
 * reference binding (java/com/google/media/codecs/ultrahdr/
 * UltraHDREncoder.java:95-501): the same public setRawImage overloads for
 * int[] (RGBA8888 / RGBA1010102), long[] (RGBAF16), short[] (P010) and
 * byte[] (YUV420) buffers, the same setter set, and the same
 * encode()/getOutput()/reset() lifecycle.  Each public overload forwards to
 * a distinctly-named native (no JNI overload mangling); the native side
 * validates through the engine's setter matrix and throws IOException
 * carrying the uhdr_error_info_t detail.
 */
package com.google.media.codecs.ultrahdr;

import static com.google.media.codecs.ultrahdr.UltraHDRCommon.*;

import java.io.IOException;

public class UltraHDREncoder implements AutoCloseable {

    // uhdr_codec_t
    public static final int UHDR_CODEC_JPG = 0;
    public static final int UHDR_CODEC_HEIF = 1;
    public static final int UHDR_CODEC_AVIF = 2;

    // uhdr_enc_preset_t
    public static final int UHDR_USAGE_REALTIME = 0;
    public static final int UHDR_USAGE_BEST_QUALITY = 1;

    static {
        System.loadLibrary("uhdr_tpu_torch_jni");
    }

    private long handle;

    public UltraHDREncoder() throws IOException {
        handle = 0;
        init();
    }

    @Override
    public void close() throws Exception {
        destroy();
    }

    /**
     * Add a 32 bits-per-pixel packed raw image (RGBA8888 or RGBA1010102)
     * to the encode session.
     */
    public void setRawImage(int[] rgbBuff, int width, int height, int rgbStride, int colorGamut,
            int colorTransfer, int colorRange, int colorFormat, int intent) throws IOException {
        if (rgbBuff == null) {
            throw new IOException("received null for image data handle");
        }
        if (width <= 0 || height <= 0) {
            throw new IOException("invalid image dimensions");
        }
        if (rgbStride < width) {
            throw new IOException("image stride smaller than width");
        }
        if (colorFormat != UHDR_IMG_FMT_32bppRGBA8888
                && colorFormat != UHDR_IMG_FMT_32bppRGBA1010102) {
            throw new IOException("unsupported color format for int[] buffer");
        }
        setRawImageNativeInt(rgbBuff, width, height, rgbStride, colorGamut, colorTransfer,
                colorRange, colorFormat, intent);
    }

    /** Add a 64 bits-per-pixel packed raw image (RGBA half float). */
    public void setRawImage(long[] rgbBuff, int width, int height, int rgbStride, int colorGamut,
            int colorTransfer, int colorRange, int colorFormat, int intent) throws IOException {
        if (rgbBuff == null) {
            throw new IOException("received null for image data handle");
        }
        if (width <= 0 || height <= 0) {
            throw new IOException("invalid image dimensions");
        }
        if (rgbStride < width) {
            throw new IOException("image stride smaller than width");
        }
        if (colorFormat != UHDR_IMG_FMT_64bppRGBAHalfFloat) {
            throw new IOException("unsupported color format for long[] buffer");
        }
        setRawImageNativeLong(rgbBuff, width, height, rgbStride, colorGamut, colorTransfer,
                colorRange, colorFormat, intent);
    }

    /** Add a 10-bit planar raw image (P010: Y plane + interleaved UV). */
    public void setRawImage(short[] yBuff, short[] uvBuff, int width, int height,
            int yStride, int uvStride, int colorGamut, int colorTransfer,
            int colorRange, int colorFormat, int intent) throws IOException {
        if (yBuff == null || uvBuff == null) {
            throw new IOException("received null for image data handle");
        }
        if (width <= 0 || height <= 0) {
            throw new IOException("invalid image dimensions");
        }
        if (yStride < width || uvStride < width) {
            throw new IOException("image stride smaller than width");
        }
        if (colorFormat != UHDR_IMG_FMT_24bppYCbCrP010) {
            throw new IOException("unsupported color format for short[] buffers");
        }
        setRawImageNativeP010(yBuff, uvBuff, width, height, yStride, uvStride, colorGamut,
                colorTransfer, colorRange, colorFormat, intent);
    }

    /** Add an 8-bit planar raw image (YUV420: three planes). */
    public void setRawImage(byte[] yBuff, byte[] uBuff, byte[] vBuff, int width, int height,
            int yStride, int uStride, int vStride, int colorGamut, int colorTransfer,
            int colorRange, int colorFormat, int intent) throws IOException {
        if (yBuff == null || uBuff == null || vBuff == null) {
            throw new IOException("received null for image data handle");
        }
        if (width <= 0 || height <= 0) {
            throw new IOException("invalid image dimensions");
        }
        if (yStride < width || uStride < width / 2 || vStride < width / 2) {
            throw new IOException("image stride smaller than width");
        }
        if (colorFormat != UHDR_IMG_FMT_12bppYCbCr420) {
            throw new IOException("unsupported color format for byte[] planes");
        }
        setRawImageNativeYuv420(yBuff, uBuff, vBuff, width, height, yStride, uStride, vStride,
                colorGamut, colorTransfer, colorRange, colorFormat, intent);
    }

    /** Add a compressed (JPEG) intent to the encode session. */
    public void setCompressedImage(byte[] data, int size, int colorGamut, int colorTransfer,
            int range, int intent) throws IOException {
        if (data == null) {
            throw new IOException("received null for image data handle");
        }
        if (size <= 0) {
            throw new IOException("invalid compressed image size");
        }
        setCompressedImageNative(data, size, colorGamut, colorTransfer, range, intent);
    }

    /** Add a compressed gain map + its metadata (API-4 passthrough). */
    public void setGainMapImageInfo(byte[] data, int size, float[] maxContentBoost,
            float[] minContentBoost, float[] gainmapGamma, float[] offsetSdr, float[] offsetHdr,
            float hdrCapacityMin, float hdrCapacityMax, boolean useBaseColorSpace)
            throws IOException {
        if (data == null) {
            throw new IOException("received null for gainmap data handle");
        }
        if (size <= 0) {
            throw new IOException("invalid gainmap image size");
        }
        setGainMapImageInfoNative(data, size, maxContentBoost, minContentBoost, gainmapGamma,
                offsetSdr, offsetHdr, hdrCapacityMin, hdrCapacityMax, useBaseColorSpace);
    }

    public void setExifData(byte[] data, int size) throws IOException {
        if (data == null) {
            throw new IOException("received null for exif data handle");
        }
        if (size <= 0) {
            throw new IOException("invalid exif size");
        }
        setExifDataNative(data, size);
    }

    public void setQualityFactor(int qualityFactor, int intent) throws IOException {
        setQualityFactorNative(qualityFactor, intent);
    }

    public void setMultiChannelGainMapEncoding(boolean enable) throws IOException {
        setMultiChannelGainMapEncodingNative(enable);
    }

    public void setGainMapScaleFactor(int scaleFactor) throws IOException {
        setGainMapScaleFactorNative(scaleFactor);
    }

    public void setGainMapGamma(float gamma) throws IOException {
        setGainMapGammaNative(gamma);
    }

    public void setEncPreset(int preset) throws IOException {
        setEncPresetNative(preset);
    }

    public void setOutputFormat(int mediaType) throws IOException {
        setOutputFormatNative(mediaType);
    }

    public void setMinMaxContentBoost(float minContentBoost, float maxContentBoost)
            throws IOException {
        setMinMaxContentBoostNative(minContentBoost, maxContentBoost);
    }

    public void setTargetDisplayPeakBrightness(float nits) throws IOException {
        setTargetDisplayPeakBrightnessNative(nits);
    }

    /** Encode the configured intents into a JPEG_R stream. */
    public void encode() throws IOException {
        encodeNative();
    }

    /** Return the encoded stream; valid after {@link #encode()}. */
    public byte[] getOutput() throws IOException {
        return getOutputNative();
    }

    /** Clear all settings; the instance is reusable afterwards. */
    public void reset() throws IOException {
        resetNative();
    }

    private native void init() throws IOException;

    private native void destroy() throws IOException;

    private native void setRawImageNativeInt(int[] rgbBuff, int width, int height, int rgbStride,
            int colorGamut, int colorTransfer, int colorRange, int colorFormat, int intent)
            throws IOException;

    private native void setRawImageNativeLong(long[] rgbBuff, int width, int height,
            int rgbStride, int colorGamut, int colorTransfer, int colorRange, int colorFormat,
            int intent) throws IOException;

    private native void setRawImageNativeP010(short[] yBuff, short[] uvBuff, int width,
            int height, int yStride, int uvStride, int colorGamut, int colorTransfer,
            int colorRange, int colorFormat, int intent) throws IOException;

    private native void setRawImageNativeYuv420(byte[] yBuff, byte[] uBuff, byte[] vBuff,
            int width, int height, int yStride, int uStride, int vStride, int colorGamut,
            int colorTransfer, int colorRange, int colorFormat, int intent) throws IOException;

    private native void setCompressedImageNative(byte[] data, int size, int colorGamut,
            int colorTransfer, int range, int intent) throws IOException;

    private native void setGainMapImageInfoNative(byte[] data, int size, float[] maxContentBoost,
            float[] minContentBoost, float[] gainmapGamma, float[] offsetSdr, float[] offsetHdr,
            float hdrCapacityMin, float hdrCapacityMax, boolean useBaseColorSpace)
            throws IOException;

    private native void setExifDataNative(byte[] data, int size) throws IOException;

    private native void setQualityFactorNative(int qualityFactor, int intent) throws IOException;

    private native void setMultiChannelGainMapEncodingNative(boolean enable) throws IOException;

    private native void setGainMapScaleFactorNative(int scaleFactor) throws IOException;

    private native void setGainMapGammaNative(float gamma) throws IOException;

    private native void setEncPresetNative(int preset) throws IOException;

    private native void setOutputFormatNative(int mediaType) throws IOException;

    private native void setMinMaxContentBoostNative(float minContentBoost, float maxContentBoost)
            throws IOException;

    private native void setTargetDisplayPeakBrightnessNative(float nits) throws IOException;

    private native void encodeNative() throws IOException;

    private native byte[] getOutputNative() throws IOException;

    private native void resetNative() throws IOException;
}
