/*
 * Sample app for the Java binding of the PyTorch/CUDA port — the analog of the
 * reference's java/UltraHdrApp.java: encode a raw P010 file into JPEG_R, or
 * decode a JPEG_R file and dump the raw output.
 *
 *   java UltraHdrApp encode <in.p010> <width> <height> <out.jpg>
 *   java UltraHdrApp decode <in.jpg> <out.raw>
 */

import static com.google.media.codecs.ultrahdr.UltraHDRCommon.*;

import com.google.media.codecs.ultrahdr.UltraHDRDecoder;
import com.google.media.codecs.ultrahdr.UltraHDRDecoder.RawImage;
import com.google.media.codecs.ultrahdr.UltraHDREncoder;

import java.io.FileOutputStream;
import java.nio.ByteBuffer;
import java.nio.ByteOrder;
import java.nio.file.Files;
import java.nio.file.Paths;

public class UltraHdrApp {

    private static short[] toShorts(byte[] raw, int count, int offset) {
        short[] out = new short[count];
        ByteBuffer bb = ByteBuffer.wrap(raw, offset * 2, count * 2);
        bb.order(ByteOrder.LITTLE_ENDIAN);
        bb.asShortBuffer().get(out);
        return out;
    }

    private static void encode(String inFile, int width, int height, String outFile)
            throws Exception {
        byte[] raw = Files.readAllBytes(Paths.get(inFile));
        int ySamples = width * height;
        int uvSamples = width * (height / 2);
        if (raw.length < 2 * (ySamples + uvSamples)) {
            throw new IllegalArgumentException("p010 file smaller than W*H*3 bytes");
        }
        short[] y = toShorts(raw, ySamples, 0);
        short[] uv = toShorts(raw, uvSamples, ySamples);
        try (UltraHDREncoder enc = new UltraHDREncoder()) {
            enc.setRawImage(y, uv, width, height, width, width, UHDR_CG_BT2100,
                    UHDR_CT_HLG, UHDR_CR_FULL_RANGE, UHDR_IMG_FMT_24bppYCbCrP010,
                    UHDR_HDR_IMG);
            enc.setQualityFactor(95, UHDR_BASE_IMG);
            enc.encode();
            byte[] out = enc.getOutput();
            try (FileOutputStream fos = new FileOutputStream(outFile)) {
                fos.write(out);
            }
            System.out.println("wrote " + out.length + " bytes to " + outFile);
        }
    }

    private static void decode(String inFile, String outFile) throws Exception {
        byte[] data = Files.readAllBytes(Paths.get(inFile));
        if (!UltraHDRDecoder.isUHDRImage(data, data.length)) {
            throw new IllegalArgumentException(inFile + " is not an ultra hdr image");
        }
        try (UltraHDRDecoder dec = new UltraHDRDecoder()) {
            dec.setCompressedImage(data, data.length, UHDR_CG_UNSPECIFIED,
                    UHDR_CT_UNSPECIFIED, UHDR_CR_UNSPECIFIED);
            dec.probe();
            System.out.println("image " + dec.getImageWidth() + "x" + dec.getImageHeight()
                    + ", gain map " + dec.getGainMapWidth() + "x" + dec.getGainMapHeight());
            dec.setOutputFormat(UHDR_IMG_FMT_32bppRGBA1010102);
            dec.setColorTransfer(UHDR_CT_HLG);
            dec.decode();
            RawImage img = dec.getDecodedImage();
            try (FileOutputStream fos = new FileOutputStream(outFile)) {
                fos.write(img.nativeOrderBuffer);
            }
            System.out.println("wrote " + img.nativeOrderBuffer.length + " bytes to "
                    + outFile);
        }
    }

    public static void main(String[] args) throws Exception {
        if (args.length >= 5 && args[0].equals("encode")) {
            encode(args[1], Integer.parseInt(args[2]), Integer.parseInt(args[3]), args[4]);
        } else if (args.length >= 3 && args[0].equals("decode")) {
            decode(args[1], args[2]);
        } else {
            System.err.println("usage:\n  UltraHdrApp encode <in.p010> <w> <h> <out.jpg>"
                    + "\n  UltraHdrApp decode <in.jpg> <out.raw>");
            System.exit(1);
        }
    }
}
