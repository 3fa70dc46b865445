"""Command-line converters mirroring the reference's `ntsc` CLI
(crt_main.c:37-283) and `ntsc_video` batch converter
(extra/video_convert.c:149-281), on the CUDA card.

    ntsc-torch [-s SYSTEM] [--fmt FMT] [--vfac N] [--bloom] [--eq MODE] \\
               [--no-vsync] [--no-hsync] \\
               -m|o|f|p|r|h|a outwidth outheight noise artifact_hue \\
               infile outfile
    ntsc-video-torch [-s system] [-a] [-l scanlines] [-p] [--vfac N] \\
                     [--bloom] [--eq MODE] nframes framedir outdir

--vfac sets the vertical stretch factor (struct CRT v_fac, crt_core.h:86).
--bloom / --eq conv7|conv6|conv5|conv4 / --no-vsync / --no-hsync select the
reference's compile-time build variants (CRT_DO_BLOOM crt_core.h:70,
USE_CONVOLUTION crt_core.c:85-147, CRT_DO_VSYNC/HSYNC crt_core.h:71-72).

The image converter accumulates 4 frames with blend=1 scanlines=1,
toggling field/frame parity for interlace (crt_main.c:235-255).

-s selects the system preset (the reference selects it at compile time via
CMake CRT_SYSTEM, CMakeLists.txt:12); NES is rejected like the reference's
"no NES command line version" #error (crt_main.c:25-27).  --fmt selects the
output pixel format (rgb/bgr/argb/rgba/abgr/bgra, crt_core.c:613-656); raw
format bytes are written verbatim when the outfile ends in .raw, otherwise
the image container gets the canonical RGB view.

The port of ``ntsc_crt_tpu/cli.py``: the same flags and the same output
bytes.  ``main`` and ``video_main`` take ``device=`` as a Python keyword
(None: the CUDA card, and an error where there is none).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _build_step(cfg, noise, mon, *, as_color=1, raw=False, v_fac=0,
                **mode_kw):
    """The CLI's frame step: pipeline.step with the run's fixed knobs."""
    from ntsc_crt_tpu_torch.models import pipeline

    def call(state, img, field, frame, dco, hue=0, do_ab=0):
        return pipeline.step(cfg, state, img, field=field, frame=frame,
                             hue=hue, noise=noise, mon=mon,
                             as_color=as_color, raw=raw,
                             dot_crawl_offset=dco, do_aberration=do_ab,
                             v_fac=v_fac, **mode_kw)

    return call


def main(argv=None, *, device=None):
    argv = list(argv) if argv is not None else sys.argv[1:]

    system, fmt_name, v_fac, eq_mode = "NTSC", "rgb", 0, "threeband"
    do_bloom = do_vsync = do_hsync = None
    for flag in ("--bloom", "--no-vsync", "--no-hsync"):
        if flag in argv:
            argv.remove(flag)
            if flag == "--bloom":       # CRT_DO_BLOOM build (crt_core.h:70)
                do_bloom = True
            elif flag == "--no-vsync":  # CRT_DO_VSYNC=0 (crt_core.h:71)
                do_vsync = False
            else:                       # CRT_DO_HSYNC=0 (crt_core.h:72)
                do_hsync = False
    for opt in ("-s", "--fmt", "--vfac", "--eq"):
        if opt in argv:
            i = argv.index(opt)
            val = argv[i + 1]
            del argv[i:i + 2]
            if opt == "-s":
                system = val.upper()
            elif opt == "--vfac":
                v_fac = int(val)    # vertical stretch, crt_core.h:86
            elif opt == "--eq":     # USE_CONVOLUTION builds (crt_core.c:85)
                eq_mode = val.lower()
            else:
                fmt_name = val.lower()
    if system == "NES":
        # crt_main.c:25-27: "NES mode does not have a command line version"
        print("error: NES mode does not have a command line version")
        return 1

    if len(argv) < 7 or "h" in argv[0]:
        print(__doc__)
        print("sample: ntsc-torch -op 640 480 24 0 in.ppm out.ppm")
        return 1 if len(argv) < 7 else 0

    flags = argv[0].lstrip("-")
    docolor = "m" not in flags
    field = 1 if "f" in flags else 0
    progressive = "p" in flags
    raw = "r" in flags
    save_analog = "a" in flags

    dooverwrite = "o" not in flags  # -o disables the prompt (crt_main.c:102)
    outw, outh = int(argv[1]), int(argv[2])
    noise = max(0, int(argv[3]))
    hue = int(argv[4])
    hue = hue % 360 if hue >= 0 else -((-hue) % 360)  # C `hue %= 360`
    infile, outfile = argv[5], argv[6]

    if dooverwrite and Path(outfile).exists():
        c = input(f"--- file ({outfile}) already exists, overwrite? (y/n)\n")
        if not c.lower().startswith("y"):
            return 1

    import torch

    from ntsc_crt_tpu_torch.models import pipeline, video
    from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
    from ntsc_crt_tpu_torch.models.systems import SYSTEMS
    from ntsc_crt_tpu_torch.utils import formats, imageio

    device = pipeline.resolve_device(device)
    img = imageio.read_image(infile)
    print(f"loaded {img.shape[1]} {img.shape[0]}")

    cfg = SYSTEMS[system]
    out_fmt = formats.by_name(fmt_name)
    mon = MonitorParams(blend=1, scanlines=1)
    state = pipeline.crt_init(cfg, outw, outh, device=device)
    step = _build_step(cfg, noise, mon, as_color=1 if docolor else 0,
                       raw=raw, v_fac=v_fac, do_bloom=bool(do_bloom),
                       eq_mode=eq_mode, do_vsync=do_vsync is not False,
                       do_hsync=do_hsync is not False)

    imgt = torch.as_tensor(img, device=device)
    frame = 0
    print(f"converting to {outw}x{outh}...")
    for it in range(4):  # accumulate 4 frames (crt_main.c:241-255)
        state = step(state, imgt, field, frame, 0, hue)
        if not (progressive or cfg.progressive):
            field ^= 1
            state = step(state, imgt, field, frame, 0, hue)
            if (it & 1) == 0:
                frame ^= 1

    if save_analog:
        out = video.analog_dump(cfg, state.analog).cpu().numpy()
    else:
        out = state.out.cpu().numpy()
    if str(outfile).endswith(".raw"):
        # raw bytes in the selected pixel format (crt_core.c:613-656)
        with open(outfile, "wb") as f:
            f.write(formats.from_rgb(out, out_fmt).tobytes())
    else:
        imageio.write_image(outfile, out)
    print("done")
    return 0


def video_main(argv=None, *, device=None):
    argv = argv if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(
        prog="ntsc-video-torch",
        description="convert numbered BMP/PPM frame sequences "
                    "(frames/%06d.bmp -> output/%06d.bmp), like ntsc_video")
    ap.add_argument("nframes", type=int)
    ap.add_argument("framedir", nargs="?", default="frames")
    ap.add_argument("outdir", nargs="?", default="output")
    ap.add_argument("-s", "--system", default="NTSCVHS",
                    help="system preset (default NTSCVHS like ntsc_video)")
    ap.add_argument("-a", "--aberration", action="store_true",
                    help="enable VHS head-switch aberration")
    ap.add_argument("-l", "--scanlines", action="store_true")
    ap.add_argument("-p", "--progressive", action="store_true")
    ap.add_argument("-n", "--noise", type=int, default=24)
    ap.add_argument("-W", "--outw", type=int, default=640)
    ap.add_argument("-H", "--outh", type=int, default=480)
    ap.add_argument("--vfac", type=int, default=0,
                    help="vertical stretch factor (crt_core.h:86)")
    ap.add_argument("--bloom", action="store_true",
                    help="CRT_DO_BLOOM beam-energy bloom (crt_core.h:70)")
    ap.add_argument("--eq", default="threeband",
                    choices=["threeband", "conv7", "conv6", "conv5", "conv4"],
                    help="decode EQ: 3-band or USE_CONVOLUTION FIR builds")
    args = ap.parse_args(argv)

    import concurrent.futures as cf

    import torch

    from ntsc_crt_tpu_torch.models import pipeline
    from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
    from ntsc_crt_tpu_torch.models.systems import SYSTEMS
    from ntsc_crt_tpu_torch.utils import imageio, native_io

    device = pipeline.resolve_device(device)
    cfg = SYSTEMS[args.system.upper()]
    mon = MonitorParams(blend=0, scanlines=1 if args.scanlines else 0,
                        saturation=10)
    state = pipeline.crt_init(cfg, args.outw, args.outh, device=device)
    step = _build_step(cfg, args.noise, mon, v_fac=args.vfac,
                       do_bloom=args.bloom, eq_mode=args.eq)
    do_ab = 1 if args.aberration else 0

    Path(args.outdir).mkdir(exist_ok=True)

    def src_path(i):
        src = Path(args.framedir) / f"{i:06d}.bmp"
        return src if src.exists() else Path(args.framedir) / f"{i:06d}.ppm"

    # Pipelined I/O: the reference converter decodes, converts, and encodes
    # strictly serially (extra/video_convert.c:246-277).  Here the threaded
    # native codec (native/frameio.cpp, imageio fallback inside) prefetches
    # the NEXT chunk of frames and writes the previous chunk's results while
    # the device runs the current chunk — frame order, state threading, and
    # output bytes are identical to the serial loop.
    CHUNK = 8
    if args.nframes <= 0:
        return 0
    probe = imageio.read_image(src_path(0))          # frame geometry for the
    fh, fw = probe.shape[0], probe.shape[1]          # native batch decoder
    chunks = [list(range(b, min(b + CHUNK, args.nframes)))
              for b in range(0, args.nframes, CHUNK)]

    def read_chunk(idxs):
        return native_io.read_batch([src_path(i) for i in idxs], fh, fw)

    with cf.ThreadPoolExecutor(1) as reader, \
            cf.ThreadPoolExecutor(1) as writer:
        fut = reader.submit(read_chunk, chunks[0])
        pending = None
        field = frame = 0
        outs = torch.empty((CHUNK, args.outh, args.outw, 3),
                           dtype=torch.uint8, device=device)
        for ci, idxs in enumerate(chunks):
            imgs = torch.as_tensor(fut.result(), device=device)
            if ci + 1 < len(chunks):
                fut = reader.submit(read_chunk, chunks[ci + 1])
            for k, i in enumerate(idxs):
                state = step(state, imgs[k], field, frame,
                             i % max(cfg.cc_vper, 1), do_ab=do_ab)
                outs[k].copy_(state.out)
                if not (args.progressive or cfg.progressive):
                    field ^= 1
                    if (i & 1) == 0:
                        frame ^= 1
                print(f"frame {i + 1} / {args.nframes}")
            batch = outs[:len(idxs)].cpu().numpy()  # one copy a chunk
            if pending is not None:
                pending.result()                     # surface write errors
            pending = writer.submit(
                native_io.write_batch,
                [str(Path(args.outdir) / f"{i:06d}.bmp") for i in idxs],
                batch)
        if pending is not None:
            pending.result()
    print("ffmpeg -r 30 -i output/%06d.bmp -c:v libx264 out.mp4")
    return 0


if __name__ == "__main__":
    sys.exit(main())
