"""Make the arithmetic-coded JPEG fixtures of tests/test_torch_fastio_arith.py.

Every fixture is a baseline JPEG whose quantised coefficients recode.c
re-codes with arithmetic coding (libjpeg's jpeg_write_coefficients with
arith_code = TRUE): sequential (SOF9) and progressive (SOF10). Only the
entropy coding changes, so each re-coding decodes to the bytes of its
baseline source. Written next to this file:

  demo_sof9.avi, demo_sof10.avi   the 75 frames of demo_out/601_3.avi,
                                  each frame's own coefficients re-coded
  <case>.jpg                      a baseline source (cv2 wrote it)
  <case>.sof9.jpg, .sof10.jpg     its re-codings

The cases: frames 29 and 30 of the demo clip tiled to 1280x720 at quality
90 4:2:0; the 48x64 frames of tests/test_torch_fastio_progressive.py's
WHOLE (4:2:0, 4:2:2, 4:4:4 at quality 75, 4:1:1, grey, 37x101, 17x23, 1x1,
restart 1 and 3); a frame with non-default conditioning (DAC L=2, U=5, K=2); a SOF10
frame whose script of its own has non-interleaved DC first scans and DC
refinements down to Al 0 from Al 3; and a SOF9 frame of three
non-interleaved scans.

It needs a C compiler and libjpeg's headers and library built with
arithmetic coding (libjpeg-turbo 2.1.5 made the committed files; the
baseline sources are cv2's, whose encoder may differ in other versions).
Run from the repository root:

  python tests/golden/torch_arith/make_fixtures.py [--check]

--check writes nothing and reports every file whose bytes would change.
"""

from __future__ import annotations

import argparse
import pathlib
import struct
import subprocess
import sys
import tempfile

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parents[2]
DEMO = REPO / "demo_out" / "601_3.avi"
sys.path[:0] = [str(REPO), str(REPO / "tests")]

# A SOF10 script of its own: each component's DC alone, from Al 3, refined
# three times (the last interleaved), then the AC bands.
CUSTOM_SCRIPT = ";".join([
    "0:0-0:0:3", "1:0-0:0:3", "2:0-0:0:3",
    "0:1-5:0:2", "0:0-0:3:2", "1:0-0:3:2", "2:0-0:3:2",
    "1:1-63:0:1", "2:1-63:0:1", "0:6-63:0:2", "0,1,2:0-0:2:1",
    "0:1-63:2:1", "0,1,2:0-0:1:0", "0:1-63:1:0", "1:1-63:1:0", "2:1-63:1:0",
])
NON_INTERLEAVED = "0:0-63:0:0;1:0-63:0:0;2:0-63:0:0"


def demux(avi: bytes) -> list[bytes]:
    """The '00dc' frames of an AVI's movi list, in order."""
    at = avi.index(b"movi") + 4
    frames = []
    while at + 8 <= len(avi):
        tag, size = avi[at:at + 4], struct.unpack("<I", avi[at + 4:at + 8])[0]
        if tag == b"idx1":
            break
        if tag == b"00dc":
            frames.append(avi[at + 8:at + 8 + size])
        at += 8 + size + (size & 1)
    return frames


def mux(jpegs: list[bytes], h: int, w: int, fps: int = 30) -> bytes:
    """An MJPEG AVI of the given frames: hdrl (avih, one 'vids' 'MJPG'
    stream), a movi list of '00dc' chunks and an idx1 index."""
    def chunk(tag, data):
        return tag + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)

    def group(kind, body):
        return b"LIST" + struct.pack("<I", 4 + len(body)) + kind + body

    n, largest = len(jpegs), max(len(j) for j in jpegs)
    avih = struct.pack("<14I", 1_000_000 // fps, 0, 0, 0x10, n, 0, 1, largest, w, h, 0, 0, 0, 0)
    strh = b"vidsMJPG" + struct.pack("<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1, fps, 0, n, largest, 0xFFFFFFFF, 0,
                                     0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
    hdrl = group(b"hdrl", chunk(b"avih", avih) + group(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi, index, offset = [], [], 4
    for j in jpegs:
        movi.append(chunk(b"00dc", j))
        index.append(b"00dc" + struct.pack("<III", 0x10, offset, len(j)))
        offset += len(movi[-1])
    body = hdrl + group(b"movi", b"".join(movi)) + chunk(b"idx1", b"".join(index))
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"AVI " + body


def tile_720p(frame: np.ndarray) -> np.ndarray:
    h, w = frame.shape[:2]
    return np.tile(frame, (-(-720 // h), -(-1280 // w), 1))[:720, :1280]


def sources() -> dict[str, tuple[bytes, dict]]:
    """Each case's baseline JPEG and the options of its re-codings."""
    import cv2

    from opticalflowclustering_tpu_torch.io import fastio
    from test_torch_fastio_progressive import WHOLE, _encode, _frame

    out = {}
    demo = fastio.decode_mjpeg_avi(str(DEMO), max_frames=31)
    for i in (29, 30):
        ok, buf = cv2.imencode(".jpg", tile_720p(demo[i]), [cv2.IMWRITE_JPEG_QUALITY, 90,
                                                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x221111])
        assert ok
        out[f"demo{i}_720p_q90"] = (buf.tobytes(), {})
    for name in ("420_q75", "422_q90", "411_q60", "gray_q80", "420_odd_37x101_q5", "422_odd_17x23_q30",
                 "444_1x1", "420_restart1", "422_restart3_q10"):
        im, q, sampling, restart = WHOLE[name]()
        out[name] = (_encode(im, q, sampling, restart, progressive=False), {"restart": restart})
    # WHOLE's 4:4:4 frame at quality 75, not 100: a third of the size
    out["444_q75"] = (_encode(_frame(seed=2), 75, 0x111111, progressive=False), {})
    out["420_dac_l2_u5_k2"] = (_encode(_frame(seed=12), 50, progressive=False), {"dac": (2, 5, 2)})
    out["420_script"] = (_encode(_frame(seed=13), 50, progressive=False), {"sof10": CUSTOM_SCRIPT})
    out["420_non_interleaved"] = (_encode(_frame(seed=14), 50, progressive=False), {"sof9": NON_INTERLEAVED})
    return out


def recoder(tmp: pathlib.Path):
    exe = tmp / "recode"
    subprocess.run(["cc", "-O2", str(HERE / "recode.c"), "-ljpeg", "-o", str(exe)], check=True)

    def recode(jpeg: bytes, progressive: bool, restart=0, dac=None, script=None) -> bytes:
        src, dst = tmp / "in.jpg", tmp / "out.jpg"
        src.write_bytes(jpeg)
        cmd = [str(exe), str(src), str(dst), "--restart", str(restart)]
        if script:
            cmd += ["--scans", script]
        elif progressive:
            cmd.append("--progressive")
        if dac:
            cmd += ["--dac", ",".join(map(str, dac))]
        subprocess.run(cmd, check=True)
        return dst.read_bytes()

    return recode


def fixtures(tmp: pathlib.Path) -> dict[str, bytes]:
    """Every fixture's file name and bytes."""
    recode = recoder(tmp)
    files = {}
    frames = demux(DEMO.read_bytes())
    h, w = 232, 220
    for sof, progressive in (("sof9", False), ("sof10", True)):
        files[f"demo_{sof}.avi"] = mux([recode(f, progressive) for f in frames], h, w)
    for name, (jpeg, opts) in sources().items():
        files[f"{name}.jpg"] = jpeg
        restart, dac = opts.get("restart", 0), opts.get("dac")
        for sof, progressive in (("sof9", False), ("sof10", True)):
            script = opts.get(sof)
            if script is None and ("sof9" in opts or "sof10" in opts):
                continue  # a case of one script: only that re-coding
            files[f"{name}.{sof}.jpg"] = recode(jpeg, progressive, restart, dac, script)
    return files


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true", help="compare with the committed files, write nothing")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        files = fixtures(pathlib.Path(tmp))
    changed = [name for name, data in files.items()
               if not (HERE / name).exists() or (HERE / name).read_bytes() != data]
    if args.check:
        print(f"{len(files)} fixtures, {len(changed)} differ: {changed}")
        return 1 if changed else 0
    for name, data in files.items():
        (HERE / name).write_bytes(data)
    print(f"wrote {len(files)} fixtures ({sum(map(len, files.values()))} bytes) into {HERE}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
