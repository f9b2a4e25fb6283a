"""PyTorch port vs the JAX package: the native MJPEG/PNG decoder and the
native stream (opticalflowclustering_tpu_torch.io.fastio over its own
native/fastio.cpp, which links no codec library, and io.video.read_video_bgr
/ pipeline.bounce.process_video_stream with native=True ↔
opticalflowclustering_tpu.io.fastio over libjpeg-turbo and libpng, and the
same JAX functions; mirrors tests/test_fastio.py).

The port's frames are held bitwise to the JAX decoder's. Two oracles do it:
sha256 digests of the JAX decoder's output, pinned below, which hold on any
host; and, where the JAX package's library builds
(`opticalflowclustering_tpu.io.fastio.available()`), the JAX decoder run live
on the same file. PNGs are held to cv2.imread as well (lossless: bitwise).
Against cv2's video decode (FFmpeg) the contract is the JAX package's:
within 5 codes, mean < 1."""

import hashlib
import os
import pathlib
import shutil
import struct
import tempfile
import threading
import zlib

import cv2
import numpy as np
import pytest
import torch

from opticalflowclustering_tpu.io import fastio as jfastio
from opticalflowclustering_tpu_torch.io import fastio
from opticalflowclustering_tpu_torch.io.video import read_video_bgr, write_video_mjpg
from opticalflowclustering_tpu_torch.pipeline import bounce as tpl

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demo_out", "601_3.avi")


# ---------------------------------------------------------------- inputs ----

def _sin_clip():
    """tests/test_fastio.py's smooth 9-frame 64×80 clip."""
    yy, xx = np.mgrid[0:64, 0:80].astype(np.float32)
    return np.stack([
        np.stack([127.5 + 120 * np.sin(yy / 9 + i / 3), 127.5 + 120 * np.sin(xx / 11 + i / 2),
                  127.5 + 120 * np.sin((xx + yy) / 13 + i)], axis=-1).astype(np.uint8)
        for i in range(9)
    ])


def _smooth_clip(n, seed=0):
    """Video-like 48×64 frames (tests/test_fastio.py's stream and threads
    clips): noise over-stresses JPEG quantization and says nothing about the
    decoder."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:48, 0:64].astype(np.float32)
    return np.stack([
        np.stack([127.5 + 110 * np.sin(yy / 7 + i / 2), 127.5 + 110 * np.sin(xx / 9 + i / 3),
                  rng.uniform(100, 150, yy.shape)], axis=-1).astype(np.uint8)
        for i in range(n)
    ])


def _noise_clip(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 48, 64, 3), dtype=np.uint8)


def _image(h, w, seed):
    """A smooth colour image with some noise in it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    im = np.stack([127.5 + 120 * np.sin(yy / 9 + seed), 127.5 + 120 * np.sin(xx / 11),
                   127.5 + 120 * np.sin((xx + yy) / 13)], -1)
    return np.clip(im * 0.7 + rng.uniform(0, 76, im.shape), 0, 255).astype(np.uint8)


def _avi(path, jpegs):
    """A minimal AVI of the given JPEG frames: RIFF 'AVI ' holding one movi
    LIST of '00dc' chunks (what both native decoders index)."""
    movi = b"".join(b"00dc" + struct.pack("<I", len(j)) + j + b"\0" * (len(j) & 1) for j in jpegs)
    lst = b"LIST" + struct.pack("<I", 4 + len(movi)) + b"movi" + movi
    pathlib.Path(path).write_bytes(b"RIFF" + struct.pack("<I", 4 + len(lst)) + b"AVI " + lst)
    return str(path)


def _markers(jpeg):
    """(offset, marker) of each marker segment up to and including SOS."""
    out, i = [], 2
    while True:
        m = jpeg[i + 1]
        out.append((i, m))
        if m == 0xDA:
            return out
        i += 2 + int.from_bytes(jpeg[i + 2 : i + 4], "big")


def _strip_dht(jpeg):
    """The frame without its DHT segments (MJPEG's habit): the decoder must
    fall back on ITU-T T.81 Annex K.3's tables."""
    cut = [(i, i + 2 + int.from_bytes(jpeg[i + 2 : i + 4], "big")) for i, m in _markers(jpeg) if m == 0xC4]
    assert cut
    for lo, hi in reversed(cut):
        jpeg = jpeg[:lo] + jpeg[hi:]
    return jpeg


def _scan_start(jpeg):
    i, _ = _markers(jpeg)[-1]
    return i + 2 + int.from_bytes(jpeg[i + 2 : i + 4], "big")


def _encode(h, w, seed, quality=75, sampling=0x221111, restart=0, gray=False):
    im = _image(h, w, seed)
    if gray:
        im = cv2.cvtColor(im, cv2.COLOR_BGR2GRAY)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    ok, buf = cv2.imencode(".jpg", im, params)
    assert ok
    return buf.tobytes()


def _jpeg_truncated():
    j = _encode(48, 64, 4)
    return j[: _scan_start(j) + (len(j) - _scan_start(j)) * 3 // 5]


def _jpeg_flipped():
    j = bytearray(_encode(48, 64, 5, restart=2))
    at = _scan_start(j) + 200
    j[at] ^= 0x5A
    return bytes(j)


def _jpeg_lost_restart():
    j = _encode(48, 64, 6, restart=1)
    at = j.index(b"\xff\xd3", _scan_start(j))
    return j[:at] + j[at + 2 :]


# One-frame AVIs of single JPEGs: sampling 4:2:0, 4:2:2, 4:4:4, 4:4:0, 4:1:1,
# greyscale, odd sizes (partial MCUs at the right and bottom edges),
# qualities 5–100, restart intervals, no DHT, and three damaged frames (cut
# short, a flipped entropy byte, a lost RST marker) that libjpeg decodes
# with warnings.
JPEGS = {
    "420_q75": lambda: _encode(48, 64, 0),
    "422_q90": lambda: _encode(48, 64, 1, 90, 0x211111),
    "444_q100": lambda: _encode(48, 64, 2, 100, 0x111111),
    "440_q50": lambda: _encode(48, 64, 3, 50, 0x121111),
    "411_q60": lambda: _encode(48, 64, 4, 60, 0x411111),
    "gray_q80": lambda: _encode(48, 64, 5, 80, gray=True),
    "420_odd_37x101_q5": lambda: _encode(37, 101, 6, 5),
    "422_odd_17x23_q30": lambda: _encode(17, 23, 7, 30, 0x211111),
    "444_1x1": lambda: _encode(1, 1, 8, 95, 0x111111),
    "gray_odd_9x13_q20": lambda: _encode(9, 13, 9, 20, gray=True),
    "420_restart1": lambda: _encode(48, 64, 10, 85, restart=1),
    "422_restart3_q10": lambda: _encode(37, 50, 11, 10, 0x211111, restart=3),
    "420_no_dht": lambda: _strip_dht(_encode(37, 101, 12, 70, restart=2)),
    "420_truncated": _jpeg_truncated,
    "420_flipped_byte": _jpeg_flipped,
    "420_lost_restart": _jpeg_lost_restart,
}

CLIPS = {
    "sin9": lambda tmp: _written(tmp / "sin9.avi", _sin_clip()),
    "smooth23": lambda tmp: _written(tmp / "smooth23.avi", _smooth_clip(23)),
    "smooth24_seed9": lambda tmp: _written(tmp / "smooth24.avi", _smooth_clip(24, seed=9)),
    "noise12_seed6": lambda tmp: _written(tmp / "noise12.avi", _noise_clip(12, 6)),
    "demo": lambda tmp: DEMO,
}


def _written(path, frames):
    write_video_mjpg(str(path), frames, 30.0)
    return str(path)


def _case_path(name, tmp):
    if name in CLIPS:
        return CLIPS[name](tmp)
    return _avi(tmp / f"{name}.avi", [JPEGS[name]()])


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


# sha256 of opticalflowclustering_tpu.io.fastio.decode_mjpeg_avi (libjpeg-turbo
# 2.1.5, JCS_EXT_BGR, no fancy upsampling, ISLOW) on each case, made by
#   JAX_PLATFORMS=cpu python -c "import sys; sys.path[:0] = ['.', 'tests']; \
#     import test_torch_fastio as t; t.print_jax_digests()"
JAX_DIGESTS = {
    "sin9": "fdf7e2460d137bc61fdd732958f3571f25b43ae3e50c257815b3e02f2866a7db",
    "smooth23": "c09127d7c16d4244cc5333def0d5af6413c6b00071b48b62e325ed244b0891bb",
    "smooth24_seed9": "ab9666eb5f1ffaad8aef3db870660a58343c374636c422646e29fd24bd1e7310",
    "noise12_seed6": "58920cbefacc3d8cfd9e5cbbe75ca8895bfc43dee842265214d6e693a606e342",
    "demo": "8211c98448d3e3118b9fe63779819b6f1e6e79aa5f1e188ae8c5d07e405a627e",
    "420_q75": "e4050dd3946fcf3e0d7db5d663afc191de266910d1f9dfd7d28e9a72af12de38",
    "422_q90": "2f9a6c6447824f89c23de82a97f386e06df9e237addc36b9e902a965e5efc14f",
    "444_q100": "703aaa093c86c5fc7bfeeee0d1e181b797d0a4edf4a4ba0dd93a43abf662b79f",
    "440_q50": "4c3880f5110391ed0584ce33933a713fd3c552202b3af48e4801ddec178219f8",
    "411_q60": "5b335465f2946d4c50067cd566bb70461b84fccd2be855fdfc1ebd9ccb192f5e",
    "gray_q80": "1519dc813efe0198caf5ab28fd12d26d405c85ec6047ca7427c9a2fa34a78106",
    "420_odd_37x101_q5": "ea8378ec3a6ebffd8ac6e5f808d4815c183d3c865811b39d71acec28703c6c15",
    "422_odd_17x23_q30": "ccc9e28a85ef8f9a9edfed5ddd96e5dff314f167165113ceef01c0c01dd95747",
    "444_1x1": "8e7da991ec29c41e8dcc6874d8aadb23448287b0ec5dd64e18478a2f11e5b03d",
    "gray_odd_9x13_q20": "8d6787e1b1cfaf723c521c38d4c605300f63154746c8063a2a4395594a182468",
    "420_restart1": "e10b1e94bed4207872eac9a8e085ffb0f3f96744cdde085632de7e4b46cdc6f2",
    "422_restart3_q10": "198496938c52323e1d93ef4ca12b8c22e724cb1d4e3778282b05c90bf3de75f8",
    "420_no_dht": "de4b50f00a75310ff9211fe83e37afffc3f85a830b34559cf30009ad015a6b41",
    "420_truncated": "f5c7122307612ca8b55d5245747305ef5a134072095d1d2800d332c45ce84366",
    "420_flipped_byte": "d436de7618e70301dcc5a78e69b7467a90b21a11830915e8439063c942fe95dd",
    "420_lost_restart": "85a11b9db689dd18e01ad0e0986b3e35f9e8385a9730163320a59e76b9938c32",
}


def test_chip_smoke_pins_the_jax_demo_digest():
    """chip_smoke.py holds the card's decode of the demo clip to the same
    JAX digest as these tests."""
    import chip_smoke

    assert chip_smoke.DEMO_NATIVE_SHA256 == JAX_DIGESTS["demo"]


def print_jax_digests():
    """Print JAX_DIGESTS anew from the JAX package's decoder."""
    with tempfile.TemporaryDirectory() as tmp:
        for name in [*CLIPS, *JPEGS]:
            path = _case_path(name, pathlib.Path(tmp))
            print(f'    "{name}": "{_digest(jfastio.decode_mjpeg_avi(path))}",')


# ---------------------------------------------------------------- PNGs ----

def _png_chunk(tag, data):
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def _filter_rows(rows, bpp, rng):
    """Each row with a random filter of the five (PNG spec §9)."""
    out, prev = [], bytes(len(rows[0]))
    for row in rows:
        f = int(rng.integers(0, 5))
        cur = bytearray(len(row))
        for k, x in enumerate(row):
            a = row[k - bpp] if k >= bpp else 0
            b = prev[k]
            c = prev[k - bpp] if k >= bpp else 0
            if f == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
            else:
                pred = (0, a, b, (a + b) // 2)[f]
            cur[k] = (x - pred) & 255
        out.append(bytes([f]) + bytes(cur))
        prev = row
    return b"".join(out)


def _pack_rows(samples, depth):
    """[rows, samples] ints → packed rows of `depth` bits per sample, MSB
    first, 16-bit big-endian."""
    if depth == 16:
        return [r.astype(">u2").tobytes() for r in samples]
    if depth == 8:
        return [r.astype(np.uint8).tobytes() for r in samples]
    bits = (samples[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return [np.packbits(r.reshape(-1)).tobytes() for r in bits]


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png(samples, color, depth, interlace, compression, plte=None, trns=None, seed=0):
    """PNG bytes of [h, w, channels] samples, filtered row by row at random,
    deflated stored (level 0), with fixed codes or with dynamic ones, the
    data split over two IDAT chunks."""
    rng = np.random.default_rng(seed)
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter_rows(_pack_rows(sub.reshape(sub.shape[0], -1), depth), bpp, rng)
    level, strategy = {"stored": (0, zlib.Z_DEFAULT_STRATEGY), "fixed": (6, zlib.Z_FIXED),
                       "dynamic": (9, zlib.Z_DEFAULT_STRATEGY)}[compression]
    co = zlib.compressobj(level, zlib.DEFLATED, 15, 8, strategy)
    z = co.compress(raw) + co.flush()
    out = b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if plte is not None:
        out += _png_chunk(b"PLTE", plte)
    if trns is not None:
        out += _png_chunk(b"tRNS", trns)
    return out + _png_chunk(b"IDAT", z[: len(z) // 2]) + _png_chunk(b"IDAT", z[len(z) // 2 :]) + _png_chunk(b"IEND", b"")


PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4), (3, 8),
             (4, 8), (4, 16), (6, 8), (6, 16)]


def _png_files(tmp, color, depth, h=13, w=17):
    """Four PNGs of one colour type and bit depth: plain and Adam7, stored,
    fixed and dynamic deflate, with a tRNS chunk where the type takes one."""
    rng = np.random.default_rng(color * 100 + depth)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    paths = []
    for i, (interlace, compression) in enumerate(((0, "dynamic"), (1, "stored"), (1, "fixed"), (0, "fixed"))):
        samples = rng.integers(0, 1 << depth, (h, w, ch))
        plte = trns = None
        if color == 3:
            n = 1 << depth
            plte = rng.integers(0, 256, 3 * n).astype(np.uint8).tobytes()
            trns = rng.integers(0, 256, n // 2 + 1).astype(np.uint8).tobytes()
        elif color == 0 and i % 2:
            trns = struct.pack(">H", int(samples[0, 0, 0]))
        elif color == 2 and i % 2:
            trns = struct.pack(">HHH", *map(int, samples[0, 0]))
        p = tmp / f"c{color}_d{depth}_{i}.png"
        p.write_bytes(_png(samples, color, depth, interlace, compression, plte, trns, seed=i))
        paths.append(str(p))
    return paths


# ---------------------------------------------------------------- tests ----

@pytest.mark.parametrize("case", [*CLIPS, *JPEGS, *(f"png_c{c}_d{d}" for c, d in PNG_KINDS)])
def test_decode_is_bitwise_the_jax_decoders(case, tmp_path):
    """Each clip, single JPEG and crafted PNG: the port's decode against the
    pinned digest of the JAX decoder's (PNGs: against cv2.imread), and
    against the JAX decoder live where its library builds."""
    if case.startswith("png_"):
        color, depth = (int(x[1:]) for x in case.split("_")[1:])
        paths = _png_files(tmp_path, color, depth)
        got = fastio.decode_png_batch(paths, 13, 17)
        np.testing.assert_array_equal(got, np.stack([cv2.imread(p) for p in paths]))
        if jfastio.available():
            np.testing.assert_array_equal(got, jfastio.decode_png_batch(paths, 13, 17))
        return
    path = _case_path(case, tmp_path)
    got = fastio.decode_mjpeg_avi(path)
    assert got.dtype == np.uint8 and got.ndim == 4 and got.shape[-1] == 3
    assert _digest(got) == JAX_DIGESTS[case]
    if jfastio.available():
        np.testing.assert_array_equal(got, jfastio.decode_mjpeg_avi(path))


def test_a_frame_without_dht_decodes_with_the_standard_tables(tmp_path):
    """MJPEG frames omit their Huffman tables when they are T.81 Annex K.3's:
    a frame that cv2 wrote with those tables decodes to the same bytes
    with its DHT segments removed (all four tables in use: 4:2:0 colour,
    restart interval 2)."""
    jpeg = _encode(37, 101, 12, 70, restart=2)
    np.testing.assert_array_equal(fastio.decode_mjpeg_avi(_avi(tmp_path / "a.avi", [_strip_dht(jpeg)])),
                                  fastio.decode_mjpeg_avi(_avi(tmp_path / "b.avi", [jpeg])))


@pytest.mark.parametrize("case", ["sin9", "demo"])
def test_native_decode_is_within_the_jax_bound_of_cv2(case, tmp_path):
    """tests/test_fastio.py's contract against cv2's decode (FFmpeg): within
    5 codes, mean < 1; read_video_bgr(native=True) is the native decode, and
    max_frames is honoured on both routes."""
    path = _case_path(case, tmp_path)
    got = fastio.decode_mjpeg_avi(path)
    want = read_video_bgr(path)
    assert got.shape == want.shape
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 5 and d.mean() < 1.0, (d.max(), d.mean())
    assert not np.array_equal(got, want)  # the native route really is another decoder
    np.testing.assert_array_equal(read_video_bgr(path, native=True), got)
    np.testing.assert_array_equal(read_video_bgr(path, 4, native=True), got[:4])
    np.testing.assert_array_equal(fastio.decode_mjpeg_avi(path, max_frames=4), got[:4])
    assert fastio.decode_mjpeg_avi(path, max_frames=0).shape == (0,) + got.shape[1:]


def test_threads_1_and_8_bitwise_equal(tmp_path):
    """Frames decode across the native pool, each into its own slice: 1
    thread and 8 give the same bytes, and the stream agrees."""
    path = _case_path("smooth24_seed9", tmp_path)
    serial = fastio.decode_mjpeg_avi(path, threads=1)
    assert serial.shape == (24, 48, 64, 3)
    np.testing.assert_array_equal(serial, fastio.decode_mjpeg_avi(path, threads=8))
    chunks = [c for c, _ in fastio.stream_mjpeg_avi(path, chunk=6, overlap=0)]
    np.testing.assert_array_equal(np.concatenate(chunks)[:24], serial)


@pytest.mark.parametrize("chunk,segment", [(4, 512), (4, 10), (7, 9)])
def test_stream_equals_batch_decode(tmp_path, chunk, segment):
    """stream_mjpeg_avi reassembles to exactly decode_mjpeg_avi, across chunk
    sizes and with segment boundaries inside the clip (the carry across
    windows), in the ([chunk+1, H, W, 3], n_valid) contract; max_frames
    honoured."""
    path = _case_path("smooth23", tmp_path)
    want = fastio.decode_mjpeg_avi(path)
    got, last = [], None
    for batch, n_valid in fastio.stream_mjpeg_avi(path, chunk, overlap=1, segment=segment):
        assert batch.shape == (chunk + 1,) + want.shape[1:]
        got.append(batch[:n_valid])
        last = (batch, n_valid)
    got.append(last[0][last[1] : last[1] + 1])  # the last frame rides in the overlap slot
    np.testing.assert_array_equal(np.concatenate(got), want)
    assert sum(v for _, v in fastio.stream_mjpeg_avi(path, 4, max_frames=6, segment=segment)) == 5


def _movi_boxes(data):
    """(offset, payload size) of the first movi LIST, and the (offset, size)
    of each video chunk payload in it."""
    pos, found = 12, []
    while pos + 12 <= len(data):
        tag, sz = bytes(data[pos : pos + 4]), int.from_bytes(data[pos + 4 : pos + 8], "little")
        if tag == b"LIST" and bytes(data[pos + 8 : pos + 12]) == b"movi":
            mp = pos + 12
            while mp + 8 <= pos + 8 + sz:
                csz = int.from_bytes(data[mp + 4 : mp + 8], "little")
                if bytes(data[mp + 2 : mp + 4]) in (b"dc", b"db"):
                    found.append((mp + 8, csz))
                mp += 8 + csz + (csz & 1)
            return pos, sz, found
        pos += 8 + sz + (sz & 1)
    raise AssertionError("no movi LIST")


def test_avix_extension_segments_are_indexed(tmp_path):
    """OpenDML long files: frames in appended `RIFF....AVIX` segments are
    indexed too (crafted by appending an AVIX segment that repeats the
    primary movi): probe, batch and stream see all 2 × 9 frames."""
    path = _written(tmp_path / "base.avi", _noise_clip(9, 5))
    want = fastio.decode_mjpeg_avi(path)
    data = open(path, "rb").read()
    pos, sz, _ = _movi_boxes(data)
    movi = data[pos : pos + 8 + sz]
    odml = tmp_path / "odml.avi"
    odml.write_bytes(data + b"RIFF" + (4 + len(movi)).to_bytes(4, "little") + b"AVIX" + movi)
    assert fastio.probe_mjpeg_avi(str(odml)) == (18, 48, 64)
    np.testing.assert_array_equal(fastio.decode_mjpeg_avi(str(odml)), np.concatenate([want, want]))
    assert sum(v for _, v in fastio.stream_mjpeg_avi(str(odml), 4)) + 1 == 18


def test_stream_stalls_at_a_corrupt_frame(tmp_path):
    """A frame whose JPEG SOI marker is broken never publishes its done
    flag: the stream raises there, having yielded only frames before it,
    each bit-exact; the batch decode raises too."""
    path = _case_path("noise12_seed6", tmp_path)
    want = fastio.decode_mjpeg_avi(path)
    data = bytearray(open(path, "rb").read())
    _, _, found = _movi_boxes(data)
    assert len(found) == 12
    data[found[7][0] : found[7][0] + 2] = b"\x00\x00"
    pathlib.Path(path).write_bytes(data)
    got = []
    with pytest.raises(ValueError, match="decode failed|incomplete prefix"):
        for batch, n_valid in fastio.stream_mjpeg_avi(path, 3, overlap=1):
            got.append(np.array(batch[:n_valid]))
    delivered = np.concatenate(got) if got else np.empty((0,) + want.shape[1:], np.uint8)
    assert delivered.shape[0] <= 7
    np.testing.assert_array_equal(delivered, want[: delivered.shape[0]])
    with pytest.raises(ValueError, match=r"mjpeg decode failed \(rc=-2\)"):
        fastio.decode_mjpeg_avi(path)


@pytest.mark.parametrize("kind", ["SOF11", "SOF13", "SOF3", "12-bit"])
def test_unsupported_frames_raise_naming_their_sof(kind, tmp_path):
    """Arithmetic lossless and differential, lossless and 12-bit frames
    probe (so the native route takes their AVI) but do not decode, as
    libjpeg-turbo 2.1.5 decodes none of them: ValueError naming the SOF and
    the frames the decoder takes, from the batch and from the stream.
    (Progressive Huffman frames, SOF2, decode:
    tests/test_torch_fastio_progressive.py; arithmetic sequential and
    progressive ones, SOF9 and SOF10: tests/test_torch_fastio_arith.py.)"""
    jpeg = bytearray(_encode(24, 32, 0))
    at = jpeg.index(b"\xff\xc0")
    marker, precision, want = {"SOF11": (0xCB, 8, r"SOF11 \(arithmetic lossless, 8-bit\)"),
                               "SOF13": (0xCD, 8, r"SOF13 \(arithmetic differential sequential, 8-bit\)"),
                               "SOF3": (0xC3, 8, r"SOF3 \(lossless, 8-bit\)"),
                               "12-bit": (0xC1, 12, r"SOF1 \(sequential Huffman, 12-bit\)")}[kind]
    jpeg[at + 1], jpeg[at + 4] = marker, precision
    jpeg = bytes(jpeg)
    want += r" in .*; the decoder takes 8-bit frames: Huffman \(SOF0, SOF1, SOF2\) and arithmetic \(SOF9, SOF10\)"
    path = _avi(tmp_path / "u.avi", [jpeg, jpeg])
    assert fastio.probe_mjpeg_avi(path) == (2, 24, 32)
    with pytest.raises(ValueError, match="unsupported JPEG frame " + want):
        fastio.decode_mjpeg_avi(path)
    with pytest.raises(ValueError, match="unsupported JPEG frame " + want):
        list(fastio.stream_mjpeg_avi(path, 1))
    if jfastio.available():  # libjpeg refuses them at the header: the JAX probe fails
        with pytest.raises(ValueError, match=r"not an MJPEG AVI \(rc=-2\)"):
            jfastio.decode_mjpeg_avi(path)


def test_probe_and_sniff(tmp_path):
    path = _written(tmp_path / "c.avi", np.zeros((3, 32, 32, 3), np.uint8))
    assert fastio.is_mjpeg_avi(path) and not fastio.is_mjpeg_avi(__file__)
    assert not fastio.is_mjpeg_avi(str(tmp_path / "missing.avi"))
    assert fastio.probe_mjpeg_avi(path) == (3, 32, 32)
    assert fastio.probe_mjpeg_avi(__file__) is None
    assert fastio.probe_mjpeg_avi(str(tmp_path / "missing.avi")) is None
    with pytest.raises(ValueError, match="not an MJPEG AVI"):
        fastio.decode_mjpeg_avi(__file__)
    if jfastio.available():
        assert jfastio.probe_mjpeg_avi(path) == (3, 32, 32)


def test_png_batch_rejects_a_size_mismatch_a_missing_file_and_a_non_png(tmp_path):
    """A PNG of another size, a missing file, a file that is no PNG and a PNG
    whose IDAT is cut short each raise ValueError."""
    good = str(tmp_path / "good.png")
    cv2.imwrite(good, np.zeros((50, 50, 3), np.uint8))
    odd = str(tmp_path / "odd.png")
    cv2.imwrite(odd, np.zeros((10, 12, 3), np.uint8))
    short = tmp_path / "short.png"
    data = _png(np.zeros((50, 50, 3), np.int64), 2, 8, 0, "stored")
    short.write_bytes(data[: len(data) // 2])
    assert fastio.decode_png_batch([good], 50, 50).shape == (1, 50, 50, 3)
    for bad in ([odd], [good, str(tmp_path / "missing.png")], [good, __file__], [str(short)]):
        with pytest.raises(ValueError, match="png batch decode failed"):
            fastio.decode_png_batch(bad, 50, 50)


def test_xvid_avi_goes_to_cv2(tmp_path):
    """An XVID AVI passes the RIFF sniff but not the probe: read_video_bgr
    and process_video_stream with native=True decode it with cv2, as the
    JAX package does (its process_video_stream gives the same tables)."""
    from opticalflowclustering_tpu.pipeline import bounce as jpl
    from opticalflowclustering_tpu_torch.convert import from_jax_config

    frames = _noise_clip(6, 0)
    path = str(tmp_path / "x.avi")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"XVID"), 30.0, (64, 48))
    assert wr.isOpened()
    for f in frames:
        wr.write(f)
    wr.release()
    assert fastio.is_mjpeg_avi(path) and fastio.probe_mjpeg_avi(path) is None
    np.testing.assert_array_equal(read_video_bgr(path, native=True), read_video_bgr(path))
    jcfg = jpl.PipelineConfig(chunk=4, emit_flow_bgr=False)
    out = tpl.process_video_stream(path, from_jax_config(jcfg), native=True, device="cpu")
    want = jpl.process_video_stream(path, jcfg, native=True)
    assert out["hue_table"].shape == (5, 350)
    for k in ("hue_table", "rgb_hue_table", "centroids"):
        np.testing.assert_array_equal(out[k], np.asarray(want[k]), err_msg=k)


def test_native_stream_equals_the_jax_native_stream_and_process_frames(tmp_path):
    """tpl.process_video_stream(native=True) on a 12-frame 70×100 MJPG clip
    (chunk 4: three chunks) ↔ jpl.process_video_stream(native=True) (where
    the JAX library builds; else jpl.process_frames of the same frames, which
    the digests tie to its decoder): integer tables bitwise, mean |flow|
    within rtol 1e-5; and ↔ tpl.process_frames of fastio.decode_mjpeg_avi's
    frames, bitwise. The frames differ from cv2's, so the native path ran."""
    from opticalflowclustering_tpu.features.grid import GridParams as JGrid
    from opticalflowclustering_tpu.flow.farneback import FarnebackParams as JFlow
    from opticalflowclustering_tpu.pipeline import bounce as jpl
    from opticalflowclustering_tpu_torch.convert import from_jax_config

    rng = np.random.default_rng(0)
    frames = np.stack([cv2.GaussianBlur(f, (0, 0), 2) for f in rng.integers(0, 256, (12, 70, 100, 3), np.uint8)])
    for i in range(12):
        cv2.circle(frames[i], (10 + 5 * i, 30), 8, (30, 220, 200), -1)
    path = _written(tmp_path / "clip.avi", frames)
    jcfg = jpl.PipelineConfig(grid=JGrid(rows=5, cols=5), flow=JFlow(warp_mode="fast", levels=2), chunk=4,
                              emit_flow_bgr=False)
    cfg = from_jax_config(jcfg)
    got = tpl.process_video_stream(path, cfg, native=True, device="cpu")
    native = fastio.decode_mjpeg_avi(path)
    assert not np.array_equal(native, read_video_bgr(path))
    if jfastio.available():
        want_jax = jpl.process_video_stream(path, jcfg, native=True)
    else:
        want_jax = jpl.process_frames(native, jcfg)
    want = tpl.process_frames(native, cfg, device="cpu")
    assert sorted(got) == sorted(want) and got["hue_table"].shape == (11, 25)
    for k in ("hue_table", "rgb_hue_table", "centroids"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], np.asarray(want_jax[k]), err_msg=k)
    np.testing.assert_array_equal(got["mean_magnitude"], want["mean_magnitude"])
    # rtol 1e-5, not tests/test_torch_stream.py's 1e-6: on these frames the
    # flows are bitwise equal, but XLA's fused float32 mean is itself 3.6e-6
    # from the float64 mean of the JAX magnitudes (the port's is 1e-7 from it).
    np.testing.assert_allclose(got["mean_magnitude"], np.asarray(want_jax["mean_magnitude"]), rtol=1e-5)


def test_build_runs_once_under_concurrent_callers_and_is_keyed_on_the_source(tmp_path, monkeypatch):
    """The default build lands in <repo>/.torch_ext_build/fastio/; four
    threads that build into a fresh directory at once run g++ once (the
    others wait on the flock, then find the library), leave no temporary
    file, and a later call compiles nothing; another source gets another
    library."""
    assert fastio.BUILD_DIR == pathlib.Path(REPO) / ".torch_ext_build" / "fastio"
    compiles = []
    real_run = fastio.subprocess.run

    def counted(cmd, **kw):
        if "-o" in cmd:
            compiles.append(cmd)
        return real_run(cmd, **kw)

    monkeypatch.setattr(fastio.subprocess, "run", counted)
    monkeypatch.setattr(fastio, "BUILD_DIR", tmp_path / "fastio")
    results = []
    threads = [threading.Thread(target=lambda: results.append(fastio._build())) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads)
    assert len(compiles) == 1 and len(set(results)) == 1 and len(results) == 4
    so = results[0]
    assert so.parent == tmp_path / "fastio" and so.name.startswith("_fastio-") and so.suffix == ".so"
    assert sorted(os.listdir(tmp_path / "fastio")) == sorted([so.name, "lock"])
    assert fastio._build() == so and len(compiles) == 1
    other = tmp_path / "fastio.cpp"
    other.write_text(fastio.SRC.read_text() + "\n// another source\n")
    monkeypatch.setattr(fastio, "SRC", other)
    assert fastio._library_path() != so


def test_a_failed_build_raises_with_the_compilers_words(tmp_path, monkeypatch):
    """A source that does not compile: available() is False, and every
    entry point (decode, stream, probe, and the native routes of
    read_video_bgr and process_video_stream on an MJPEG AVI) raises
    RuntimeError with g++'s stderr; nothing falls back to cv2."""
    assert shutil.which("g++")
    bad = tmp_path / "fastio.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(fastio, "SRC", bad)
    monkeypatch.setattr(fastio, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(fastio, "_lib", None)
    monkeypatch.setattr(fastio, "_error", None)
    assert not fastio.available()
    words = r"native fastio unavailable: g\+\+ .*fastio\.cpp.* exited 1:\n.*fastio\.cpp:1:.*error"
    for call in (lambda: fastio.decode_mjpeg_avi(DEMO), lambda: next(fastio.stream_mjpeg_avi(DEMO, 4)),
                 lambda: fastio.probe_mjpeg_avi(DEMO), lambda: fastio.decode_png_batch([], 1, 1),
                 lambda: read_video_bgr(DEMO, 3, native=True),
                 lambda: tpl.process_video_stream(DEMO, tpl.PipelineConfig(chunk=2), 3, native=True, device="cpu")):
        with pytest.raises(RuntimeError, match=words):
            call()
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())
