/*
 * UltraHDRCommon — shared enum constants + version accessors for the Java
 * binding of the PyTorch/CUDA port (libultrahdr_tpu_torch).
 *
 * API-compatible with the reference binding
 * (java/com/google/media/codecs/ultrahdr/UltraHDRCommon.java):
 * the constant names and values mirror uhdr_img_fmt_t / uhdr_color_gamut_t /
 * uhdr_color_transfer_t / uhdr_color_range_t / uhdr_img_label_t
 * (libultrahdr_tpu_torch/capi/ultrahdr_tpu.h), so user code written against
 * the reference binding compiles unchanged.  The native side dispatches into
 * the port's engine, on the card, via its C ABI shim
 * (libultrahdr_tpu_torch/capi/uhdr_capi.cpp).
 */
package com.google.media.codecs.ultrahdr;

public class UltraHDRCommon {

    // uhdr_img_fmt_t
    public static final int UHDR_IMG_FMT_UNSPECIFIED = -1;
    public static final int UHDR_IMG_FMT_24bppYCbCrP010 = 0;
    public static final int UHDR_IMG_FMT_12bppYCbCr420 = 1;
    public static final int UHDR_IMG_FMT_8bppYCbCr400 = 2;
    public static final int UHDR_IMG_FMT_32bppRGBA8888 = 3;
    public static final int UHDR_IMG_FMT_64bppRGBAHalfFloat = 4;
    public static final int UHDR_IMG_FMT_32bppRGBA1010102 = 5;

    // uhdr_color_gamut_t
    public static final int UHDR_CG_UNSPECIFIED = -1;
    public static final int UHDR_CG_BT709 = 0;
    public static final int UHDR_CG_DISPLAY_P3 = 1;
    public static final int UHDR_CG_BT2100 = 2;

    // uhdr_color_transfer_t
    public static final int UHDR_CT_UNSPECIFIED = -1;
    public static final int UHDR_CT_LINEAR = 0;
    public static final int UHDR_CT_HLG = 1;
    public static final int UHDR_CT_PQ = 2;
    public static final int UHDR_CT_SRGB = 3;

    // uhdr_color_range_t
    public static final int UHDR_CR_UNSPECIFIED = -1;
    public static final int UHDR_CR_LIMITED_RANGE = 0;
    public static final int UHDR_CR_FULL_RANGE = 1;

    // uhdr_img_label_t
    public static final int UHDR_HDR_IMG = 0;
    public static final int UHDR_SDR_IMG = 1;
    public static final int UHDR_BASE_IMG = 2;
    public static final int UHDR_GAIN_MAP_IMG = 3;

    static {
        System.loadLibrary("uhdr_tpu_torch_jni");
    }

    /** Library version as "major.minor.patch". */
    public static String getVersionString() {
        return getVersionStringNative();
    }

    /** Library version as major*10000 + minor*100 + patch. */
    public static int getVersion() {
        return getVersionNative();
    }

    private static native String getVersionStringNative();

    private static native int getVersionNative();
}
