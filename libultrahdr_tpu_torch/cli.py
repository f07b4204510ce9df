"""Demo CLI mirroring the reference's ultrahdr_app.

Port of ``libultrahdr_tpu/cli.py`` (after examples/ultrahdr_app.cpp): the
same flag letters (:1419-1541), encode scenarios 0-4, decode, probe mode,
PSNR verification (:1191-1361) and the gain-map metadata config read and
write (examples/metadata.cfg, '--key value' per line).  One flag is added,
``--device {cuda,cpu}`` (default ``cuda``): the encoder and the decoder run
on the card unless it asks for the CPU, and a CUDA request without a GPU
raises.

Run:  python -m libultrahdr_tpu_torch.cli -m 0 -p hdr.p010 -w 1920 -h 1080 -a 0 ...
      python -m libultrahdr_tpu_torch.cli -m 1 -j in.jpg -o 1 -O 5 -z out.raw
      (add --device cpu to run on the CPU)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import (ColorGamut, ColorRange, ColorTransfer, CompressedImage,
               EncPreset, GainMapMetadata, ImgFmt, ImgLabel, RawImage,
               UhdrDecoder, UhdrEncoder, is_uhdr_image)

_HDR_FMT = {0: ImgFmt.P010, 4: ImgFmt.RGBAF16, 5: ImgFmt.RGBA1010102}
_SDR_FMT = {1: ImgFmt.YUV420, 3: ImgFmt.RGBA8888}
_CG = {0: ColorGamut.BT709, 1: ColorGamut.DISPLAY_P3, 2: ColorGamut.BT2100}
_CT = {0: ColorTransfer.LINEAR, 1: ColorTransfer.HLG, 2: ColorTransfer.PQ,
       3: ColorTransfer.SRGB}
_OUT_FMT = {3: ImgFmt.RGBA8888, 4: ImgFmt.RGBAF16, 5: ImgFmt.RGBA1010102}


def load_raw(path: str, fmt: ImgFmt, w: int, h: int, cg, ct, rng) -> RawImage:
    data = np.fromfile(path, np.uint8)
    if fmt == ImgFmt.P010:
        need = w * h * 3  # bytes: u16 Y + u16 interleaved UV at half height
        y = data[: w * h * 2].view(np.uint16).reshape(h, w)
        uv = data[w * h * 2: need].view(np.uint16).reshape(h // 2, w)
        return RawImage(fmt, cg, ct, rng, w, h, [y, uv])
    if fmt == ImgFmt.YUV420:
        y = data[: w * h].reshape(h, w)
        u = data[w * h: w * h * 5 // 4].reshape(h // 2, w // 2)
        v = data[w * h * 5 // 4: w * h * 3 // 2].reshape(h // 2, w // 2)
        return RawImage(fmt, cg, ct, rng, w, h, [y, u, v])
    if fmt == ImgFmt.RGBA1010102 or fmt == ImgFmt.RGBA8888:
        packed = data[: w * h * 4].view(np.uint32).reshape(h, w)
        return RawImage(fmt, cg, ct, rng, w, h, [packed])
    if fmt == ImgFmt.RGBAF16:
        comp = data[: w * h * 8].view(np.uint16).reshape(h, w, 4)
        return RawImage(fmt, cg, ct, rng, w, h, [comp])
    raise SystemExit(f"unsupported raw input format {fmt}")


def save_raw(img: RawImage, path: str):
    with open(path, "wb") as f:
        for p in img.planes:
            f.write(np.ascontiguousarray(p).tobytes())


def write_metadata_cfg(md: GainMapMetadata, path: str):
    """Same --key value layout the reference app writes (-f in decode)."""
    def one(v):
        a = np.asarray(v).reshape(-1)
        return " ".join(f"{float(x):g}" for x in
                        (a if a.size > 1 and not np.all(a == a[0]) else a[:1]))
    with open(path, "w") as f:
        f.write(f"--maxContentBoost {one(md.max_content_boost)}\n")
        f.write(f"--minContentBoost {one(md.min_content_boost)}\n")
        f.write(f"--gamma {one(md.gamma)}\n")
        f.write(f"--offsetSdr {one(md.offset_sdr)}\n")
        f.write(f"--offsetHdr {one(md.offset_hdr)}\n")
        f.write(f"--hdrCapacityMin {md.hdr_capacity_min:g}\n")
        f.write(f"--hdrCapacityMax {md.hdr_capacity_max:g}\n")
        f.write(f"--useBaseColorSpace {1 if md.use_base_cg else 0}\n")


def read_metadata_cfg(path: str) -> GainMapMetadata:
    md = GainMapMetadata()
    keys = {"--maxContentBoost": md.max_content_boost,
            "--minContentBoost": md.min_content_boost,
            "--gamma": md.gamma,
            "--offsetSdr": md.offset_sdr,
            "--offsetHdr": md.offset_hdr}
    for line in open(path):
        parts = line.split()
        if not parts:
            continue
        key, vals = parts[0], [float(v) for v in parts[1:]]
        if key in keys:
            keys[key][:] = np.resize(vals, 3)
        elif key == "--hdrCapacityMin":
            md.hdr_capacity_min = vals[0]
        elif key == "--hdrCapacityMax":
            md.hdr_capacity_max = vals[0]
        elif key == "--useBaseColorSpace":
            md.use_base_cg = bool(int(vals[0]))
    return md


def psnr_rgb(a: np.ndarray, b: np.ndarray, peak: float) -> list[float]:
    """Per-channel PSNR, reference formula (ultrahdr_app.cpp:1231-1281)."""
    out = []
    for c in range(3):
        mse = np.mean((a[c].astype(np.float64) - b[c].astype(np.float64)) ** 2)
        out.append(10 * np.log10(peak * peak / mse) if mse else 100.0)
    return out


def _unpack_channels(img: RawImage):
    fmt = ImgFmt(img.fmt)
    p = img.planes[0]
    if fmt == ImgFmt.RGBA1010102:
        return np.stack([(p >> s) & 0x3FF for s in (0, 10, 20)]), 1023.0
    if fmt == ImgFmt.RGBA8888:
        return np.stack([(p >> s) & 0xFF for s in (0, 8, 16)]), 255.0
    if fmt == ImgFmt.RGBAF16:
        h16 = p[..., :3].astype(np.uint16)
        f = h16.view(np.float16).astype(np.float64)
        return np.moveaxis(f, -1, 0) * 1023.0, 1023.0
    raise SystemExit(f"psnr unsupported for {fmt}")


def main(argv=None):
    ap = argparse.ArgumentParser(add_help=False, prog="uhdr_tpu_torch_app")
    ap.add_argument("-m", type=int, default=0)
    ap.add_argument("-p"), ap.add_argument("-y"), ap.add_argument("-i")
    ap.add_argument("-g"), ap.add_argument("-j"), ap.add_argument("-f")
    ap.add_argument("-w", type=int, default=0)
    ap.add_argument("-h", type=int, default=0)
    ap.add_argument("-a", type=int, default=5)
    ap.add_argument("-b", type=int, default=3)
    ap.add_argument("-C", type=int, default=1)
    ap.add_argument("-c", type=int, default=0)
    ap.add_argument("-t", type=int, default=1)
    ap.add_argument("-q", type=int, default=95)
    ap.add_argument("-R", type=int, default=0)
    ap.add_argument("-s", type=int, default=1)
    ap.add_argument("-Q", type=int, default=95)
    ap.add_argument("-G", type=float, default=1.0)
    ap.add_argument("-M", type=int, default=1)
    ap.add_argument("-D", type=int, default=1)
    ap.add_argument("-k", type=float), ap.add_argument("-K", type=float)
    ap.add_argument("-L", type=float), ap.add_argument("-x")
    ap.add_argument("-e", type=int, default=0)
    ap.add_argument("-o", type=int, default=1)
    ap.add_argument("-O", type=int, default=5)
    ap.add_argument("-u", type=int, default=0)
    ap.add_argument("-P", action="store_true")
    ap.add_argument("-z", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--help", action="help")
    args = ap.parse_args(argv)

    if args.P:
        data = open(args.j, "rb").read()
        if not is_uhdr_image(data):
            print("Not an ultra hdr image")
            return 1
        dec = UhdrDecoder(device=args.device)
        dec.set_image(data)
        dec.probe()
        print("Ultra HDR Image: Yes")
        md = dec.get_gainmap_metadata()
        print(f"--maxContentBoost {float(md.max_content_boost[0]):g}")
        print(f"--minContentBoost {float(md.min_content_boost[0]):g}")
        print(f"--hdrCapacityMax {md.hdr_capacity_max:g}")
        return 0

    if args.m == 0:
        enc = UhdrEncoder(device=args.device)
        out_path = args.z or "out.jpeg"
        if args.i and args.g:  # API-4
            enc.set_compressed_image(
                CompressedImage(open(args.i, "rb").read(), _CG[args.c]),
                ImgLabel.BASE)
            md = read_metadata_cfg(args.f) if args.f else GainMapMetadata()
            enc.set_gainmap_image(
                CompressedImage(open(args.g, "rb").read()), md)
        else:
            if not args.p:
                ap.error("-p (hdr input) required for encode scenarios 0-3")
            hdr = load_raw(args.p, _HDR_FMT[args.a], args.w, args.h,
                           _CG[args.C], _CT[args.t],
                           ColorRange.FULL if args.R else ColorRange.LIMITED
                           if _HDR_FMT[args.a] == ImgFmt.P010
                           else ColorRange.FULL)
            enc.set_raw_image(hdr, ImgLabel.HDR)
            if args.y:
                sdr = load_raw(args.y, _SDR_FMT[args.b], args.w, args.h,
                               _CG[args.c], ColorTransfer.SRGB,
                               ColorRange.FULL)
                enc.set_raw_image(sdr, ImgLabel.SDR)
            if args.i:
                enc.set_compressed_image(
                    CompressedImage(open(args.i, "rb").read(), _CG[args.c]),
                    ImgLabel.SDR)
        enc.set_quality(args.q, ImgLabel.BASE)
        enc.set_quality(args.Q, ImgLabel.GAIN_MAP)
        enc.set_gainmap_scale_factor(args.s)
        enc.set_gainmap_gamma(args.G)
        enc.set_using_multi_channel_gainmap(bool(args.M))
        enc.set_preset(EncPreset(args.D))
        if args.k is not None and args.K is not None:
            enc.set_min_max_content_boost(args.k, args.K)
        if args.L is not None:
            enc.set_target_display_peak_brightness(args.L)
        if args.x:
            enc.set_exif_data(open(args.x, "rb").read())
        data = enc.encode()
        with open(out_path, "wb") as fh:
            fh.write(data)
        print(f"encoded {len(data)} bytes -> {out_path}")
        if args.e:
            # computeRGBHdrPSNR analog (ultrahdr_app.cpp:1191-1255): decode
            # the encoded stream and compare against the HDR intent in
            # linear RGB, both normalized to the 10-bit peak
            from .ops import colors as _colors
            from .ops import pixel as _pixel
            dec = UhdrDecoder(device=args.device)
            dec.set_image(data)
            dec.set_out_img_format(_OUT_FMT[args.O])
            dec.set_out_color_transfer(_CT[args.o])
            decoded = dec.decode()
            got, peak = _unpack_channels(decoded)
            hdr_vals = _pixel.unpack(hdr, dec.device)
            if ImgFmt(hdr.fmt) not in (ImgFmt.RGBA1010102, ImgFmt.RGBAF16):
                m = _colors.yuv2rgb_matrix_for_gamut(hdr.cg)
                hdr_vals = _colors.apply_3x3(m, hdr_vals)
            hdr_vals = hdr_vals.cpu().numpy()
            want = np.clip(hdr_vals, 0.0, 1.0) * peak
            psnr = psnr_rgb(got.astype(np.float64), want, peak)
            print("PSNR rgb: %.4f %.4f %.4f" % tuple(psnr))
        return 0

    # decode
    data = open(args.j, "rb").read()
    dec = UhdrDecoder(device=args.device)
    dec.set_image(data)
    dec.set_out_img_format(_OUT_FMT[args.O])
    dec.set_out_color_transfer(_CT[args.o])
    img = dec.decode()
    out_path = args.z or "outrgb.raw"
    save_raw(img, out_path)
    print(f"decoded {img.w}x{img.h} -> {out_path}")
    if args.f:
        write_metadata_cfg(dec.get_gainmap_metadata(), args.f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
