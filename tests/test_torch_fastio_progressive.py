"""PyTorch port vs the JAX package: progressive JPEG frames (SOF2) in the
port's native MJPEG decoder (opticalflowclustering_tpu_torch.io.fastio over
its own native/fastio.cpp ↔ opticalflowclustering_tpu.io.fastio over
libjpeg-turbo 2.1.5, JCS_EXT_BGR, no fancy upsampling, ISLOW IDCT and block
smoothing at its default, on).

Every case is a one-frame AVI of a progressive JPEG that cv2 wrote (its
libjpeg's simple progression: a DC scan with Al=1, AC band scans, DC and AC
refinement scans), whole or damaged. The oracle is the sha256 of the JAX
decoder's output, pinned below, so the cases count on any host; a whole
frame must also decode to the same bytes as cv2's baseline encoding of the
same image at the same quality and sampling (the quantised coefficients are
the same, only their entropy coding differs). A frame cut short keeps the
coefficients its scans gave, and libjpeg smooths its blocks before the IDCT
(jdcoefct.c decompress_smooth_data): the cuts inside scans 1, 3 and 6 decode
differently with smoothing off, so their digests hold the port's smoothing
to the library's."""

import pathlib
import re
import tempfile

import cv2
import numpy as np
import pytest
import torch

from opticalflowclustering_tpu.io import fastio as jfastio
from opticalflowclustering_tpu_torch.io import fastio
from opticalflowclustering_tpu_torch.io.video import read_video_bgr
from opticalflowclustering_tpu_torch.pipeline import bounce as tpl
from test_torch_fastio import DEMO, _avi, _digest, _image, _sin_clip

torch.set_num_threads(1)


# ---------------------------------------------------------------- inputs ----

def _encode(im, quality=75, sampling=0x221111, restart=0, progressive=True):
    """cv2's JPEG of `im` (BGR or greyscale), progressive or baseline."""
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling,
              cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    ok, buf = cv2.imencode(".jpg", im, params)
    assert ok
    return buf.tobytes()


def _scans(jpeg):
    """(header offset, data start, data end) of each scan, in order: the
    entropy-coded data runs to the next marker that is no RSTn."""
    out, i = [], 2
    while jpeg[i + 1] != 0xD9:
        end = i + 2 + int.from_bytes(jpeg[i + 2 : i + 4], "big")
        if jpeg[i + 1] != 0xDA:
            i = end
            continue
        j = end
        while not (jpeg[j] == 0xFF and jpeg[j + 1] != 0 and not 0xD0 <= jpeg[j + 1] <= 0xD7):
            j += 1
        out.append((i, end, j))
        i = j
    return out


def _frame(h=48, w=64, seed=0, gray=False):
    im = _image(h, w, seed)
    return cv2.cvtColor(im, cv2.COLOR_BGR2GRAY) if gray else im


def _demo_frame():
    """Frame 30 of demo_out/601_3.avi as the native decoder gives it (the
    frames the JAX digests of tests/test_torch_fastio.py pin)."""
    return fastio.decode_mjpeg_avi(DEMO, max_frames=31)[30]


# Whole frames: (image, quality, sampling, restart interval).
WHOLE = {
    "420_q75": lambda: (_frame(seed=0), 75, 0x221111, 0),
    "422_q90": lambda: (_frame(seed=1), 90, 0x211111, 0),
    "444_q100": lambda: (_frame(seed=2), 100, 0x111111, 0),
    "411_q60": lambda: (_frame(seed=4), 60, 0x411111, 0),
    "gray_q80": lambda: (_frame(seed=5, gray=True), 80, 0x221111, 0),
    "420_odd_37x101_q5": lambda: (_frame(37, 101, 6), 5, 0x221111, 0),
    "422_odd_17x23_q30": lambda: (_frame(17, 23, 7), 30, 0x211111, 0),
    "444_1x1": lambda: (_frame(1, 1, 8), 95, 0x111111, 0),
    "420_restart1": lambda: (_frame(seed=10), 85, 0x221111, 1),
    "422_restart3_q10": lambda: (_frame(37, 50, 11), 10, 0x211111, 3),
    "demo_frame30_q90": lambda: (_demo_frame(), 90, 0x221111, 0),
    "420_720p_q90": lambda: (_frame(720, 1280, 3), 90, 0x221111, 0),
}


def _whole(name):
    im, q, sampling, restart = WHOLE[name]()
    return _encode(im, q, sampling, restart)


def _cut(scan):
    """The 48×64 4:2:0 frame cut in the middle of scan `scan` (1-based)."""
    j = _encode(_frame(seed=20))
    _, lo, hi = _scans(j)[scan - 1]
    return j[: (lo + hi) // 2]


def _flipped_refinement():
    """A byte in the middle of the last scan (the luma's AC refinement
    with Ah=1, Al=0) flipped."""
    j = bytearray(_encode(_frame(seed=21)))
    _, lo, hi = _scans(j)[-1]
    j[(lo + hi) // 2] ^= 0x5A
    return bytes(j)


def _lost_restart():
    """Restart interval 1, and the fourth RST marker of scan 6 (the luma's
    first AC refinement) gone: the decoder resyncs as libjpeg does."""
    j = _encode(_frame(seed=22), restart=1)
    _, lo, hi = _scans(j)[5]
    at = lo + [m.start() for m in re.finditer(rb"\xff[\xd0-\xd7]", j[lo:hi])][3]
    return j[:at] + j[at + 2 :]


def _without_dht(jpeg, scan=None):
    """The frame without its DHT segments, or only without the one right
    before scan `scan` (1-based)."""
    scans = _scans(jpeg)
    data_end = {head: end for head, _, end in scans}
    cut, i = [], 2
    while jpeg[i + 1] != 0xD9:
        if i in data_end:
            i = data_end[i]
            continue
        end = i + 2 + int.from_bytes(jpeg[i + 2 : i + 4], "big")
        if jpeg[i + 1] == 0xC4 and (scan is None or end == scans[scan - 1][0]):
            cut.append((i, end))
        i = end
    assert cut
    for lo, hi in reversed(cut):
        jpeg = jpeg[:lo] + jpeg[hi:]
    return jpeg


DAMAGED = {
    "cut_in_scan1": lambda: _cut(1),
    "cut_in_scan3": lambda: _cut(3),
    "cut_in_scan6": lambda: _cut(6),
    "cut_in_last_scan": lambda: _cut(10),
    "flipped_byte_in_refinement": _flipped_refinement,
    "lost_restart": _lost_restart,
    # the DHT of the last scan gone: it reads the table slot's earlier
    # contents (the luma's first AC refinement), which libjpeg accepts
    "stale_dht_last_scan": lambda: _without_dht(_encode(_frame(seed=23)), scan=10),
}

CASES = {**{k: lambda k=k: _whole(k) for k in WHOLE}, **DAMAGED}


def _sin_clip_avi(tmp, progressive):
    return _avi(tmp / f"sin9_{'p' if progressive else 'b'}.avi",
                [_encode(f, 90, progressive=progressive) for f in _sin_clip()])


# sha256 of opticalflowclustering_tpu.io.fastio.decode_mjpeg_avi (libjpeg-turbo
# 2.1.5, JCS_EXT_BGR, no fancy upsampling, ISLOW, block smoothing on) on each
# case, made by
#   JAX_PLATFORMS=cpu python -c "import sys; sys.path[:0] = ['.', 'tests']; \
#     import test_torch_fastio_progressive as t; t.print_jax_digests()"
JAX_DIGESTS = {
    "420_q75": "e4050dd3946fcf3e0d7db5d663afc191de266910d1f9dfd7d28e9a72af12de38",
    "422_q90": "2f9a6c6447824f89c23de82a97f386e06df9e237addc36b9e902a965e5efc14f",
    "444_q100": "703aaa093c86c5fc7bfeeee0d1e181b797d0a4edf4a4ba0dd93a43abf662b79f",
    "411_q60": "5b335465f2946d4c50067cd566bb70461b84fccd2be855fdfc1ebd9ccb192f5e",
    "gray_q80": "1519dc813efe0198caf5ab28fd12d26d405c85ec6047ca7427c9a2fa34a78106",
    "420_odd_37x101_q5": "ea8378ec3a6ebffd8ac6e5f808d4815c183d3c865811b39d71acec28703c6c15",
    "422_odd_17x23_q30": "ccc9e28a85ef8f9a9edfed5ddd96e5dff314f167165113ceef01c0c01dd95747",
    "444_1x1": "8e7da991ec29c41e8dcc6874d8aadb23448287b0ec5dd64e18478a2f11e5b03d",
    "420_restart1": "e10b1e94bed4207872eac9a8e085ffb0f3f96744cdde085632de7e4b46cdc6f2",
    "422_restart3_q10": "198496938c52323e1d93ef4ca12b8c22e724cb1d4e3778282b05c90bf3de75f8",
    "demo_frame30_q90": "a996e44beeb78276f54572331910a69d377e7168665531bd5b3ecfcec13952ce",
    "420_720p_q90": "2f4a748028f2f8a01c75cc82f5ae769d94eff7bcaa6626bc556ca1521ab084eb",
    "cut_in_scan1": "99b15145728a29a1c2578b80ea115c3caabfa972c9a6f2e1fa07ea1740dfcbab",
    "cut_in_scan3": "c11006a109db3cc832a21b12e859ae13d4c185487a01c53d06c58ef67909858f",
    "cut_in_scan6": "bc009ccb90e41f126472458b68f1cfd2d81f67b6c9046f4bb84a4112ff25d81e",
    "cut_in_last_scan": "b49aeb607ef6b86e6b4301e98ef291919b3cff56dd873ad1da397dbcb853cc71",
    "flipped_byte_in_refinement": "f2a888e97dfe941b2c98c5237bf8c780f49e90ca0fbb093c76d17ffc3e7cbbc6",
    "lost_restart": "7696697dc0b665bac502f88600ef834d91812fa374dba3cf2591afc8c02aec6d",
    "stale_dht_last_scan": "4f9fd9fef69b608a346f46273086d7b9b71dd778fda92fdcbbfbecdc7497d625",
    "sin9_clip": "a9156af6792bc0962346e69ad20da1b16d37dbfb9ec457124419c84cc0b13bf5",
}


def print_jax_digests():
    """Print JAX_DIGESTS anew from the JAX package's decoder."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        for name, make in CASES.items():
            print(f'    "{name}": "{_digest(jfastio.decode_mjpeg_avi(_avi(tmp / "c.avi", [make()])))}",')
        print(f'    "sin9_clip": "{_digest(jfastio.decode_mjpeg_avi(_sin_clip_avi(tmp, True)))}",')


# ---------------------------------------------------------------- tests ----

@pytest.mark.parametrize("case", [*CASES])
def test_progressive_decode_is_bitwise_the_jax_decoders(case, tmp_path):
    """Each progressive frame, whole or damaged: the port's decode against
    the pinned digest of the JAX decoder's, and against the JAX decoder live
    where its library loads."""
    jpeg = CASES[case]()
    assert jpeg[jpeg.index(b"\xff\xc2") + 4] == 8  # an 8-bit SOF2 frame
    path = _avi(tmp_path / "p.avi", [jpeg])
    got = fastio.decode_mjpeg_avi(path)
    assert got.dtype == np.uint8 and got.shape[0] == 1 and got.shape[-1] == 3
    assert _digest(got) == JAX_DIGESTS[case]
    if jfastio.available():
        np.testing.assert_array_equal(got, jfastio.decode_mjpeg_avi(path))


@pytest.mark.parametrize("case", [*WHOLE])
def test_whole_progressive_frame_equals_its_baseline_encoding(case, tmp_path):
    """A whole progressive frame decodes to the bytes of cv2's baseline
    encoding of the same image, quality, sampling and restart interval."""
    im, q, sampling, restart = WHOLE[case]()
    prog = fastio.decode_mjpeg_avi(_avi(tmp_path / "p.avi", [_encode(im, q, sampling, restart)]))
    base = fastio.decode_mjpeg_avi(_avi(tmp_path / "b.avi", [_encode(im, q, sampling, restart, progressive=False)]))
    np.testing.assert_array_equal(prog, base)


def _bad_scan_header(kind):
    """The 48×64 frame with one scan header broken as jdphuff.c's
    start_pass_phuff_decoder refuses: (scan, Ss, Se, Ah << 4 | Al)."""
    j = bytearray(_encode(_frame(seed=24)))
    scan, ss, se, a = {"dc_band_with_se_5": (1, 0, 5, 0x01), "ac_band_ss_above_se": (2, 5, 1, 0x02),
                       "ac_band_se_64": (2, 1, 64, 0x02), "refinement_ah_not_al_plus_1": (10, 1, 63, 0x20),
                       "al_14": (1, 0, 0, 0x0E)}[kind]
    start = _scans(bytes(j))[scan - 1][1]  # the header's last three bytes: Ss, Se, Ah/Al
    j[start - 3 : start] = bytes([ss, se, a])
    return bytes(j)


@pytest.mark.parametrize("kind", ["dc_band_with_se_5", "ac_band_ss_above_se", "ac_band_se_64",
                                  "refinement_ah_not_al_plus_1", "al_14", "no_dht"])
def test_bad_progression_and_missing_tables_fail_with_rc_2(kind, tmp_path):
    """A scan header that breaks the progression rules (a DC band with
    Se != 0, an AC band with Ss > Se or Se > 63, a refinement with
    Ah != Al + 1, Al > 13), and a progressive frame without DHT segments
    (the progressive decoder fills in no standard tables: 'Huffman table
    0x00 was not defined'), fail the frame as libjpeg's error exit does:
    rc -2, from the batch and from the stream, as in the JAX decoder."""
    jpeg = _without_dht(_encode(_frame(seed=24))) if kind == "no_dht" else _bad_scan_header(kind)
    path = _avi(tmp_path / "bad.avi", [jpeg, jpeg])
    assert fastio.probe_mjpeg_avi(path) == (2, 48, 64)
    with pytest.raises(ValueError, match=r"mjpeg decode failed \(rc=-2\)"):
        fastio.decode_mjpeg_avi(path)
    with pytest.raises(ValueError, match=r"mjpeg stream decode failed \(rc=-2\)"):
        list(fastio.stream_mjpeg_avi(path, 1))
    if jfastio.available():
        with pytest.raises(ValueError, match=r"mjpeg decode failed \(rc=-2\)"):
            jfastio.decode_mjpeg_avi(path)


def test_progressive_clip_threads_stream_and_read_video(tmp_path):
    """A 9-frame progressive clip: 1 thread and 8 give the same bytes, the
    stream reassembles to them, read_video_bgr(native=True) gives them, they
    hash to the JAX decoder's, and they equal the baseline clip's."""
    path = _sin_clip_avi(tmp_path, True)
    serial = fastio.decode_mjpeg_avi(path, threads=1)
    assert serial.shape == (9, 64, 80, 3)
    assert _digest(serial) == JAX_DIGESTS["sin9_clip"]
    np.testing.assert_array_equal(fastio.decode_mjpeg_avi(path, threads=8), serial)
    chunks = [c[:n] for c, n in fastio.stream_mjpeg_avi(path, chunk=4, overlap=0)]
    np.testing.assert_array_equal(np.concatenate(chunks), serial)
    np.testing.assert_array_equal(read_video_bgr(path, native=True), serial)
    np.testing.assert_array_equal(fastio.decode_mjpeg_avi(_sin_clip_avi(tmp_path, False)), serial)


def test_progressive_clip_streams_to_the_baseline_clips_tables(tmp_path, monkeypatch):
    """process_video_stream(native=True) on a progressive clip gives the
    tables of the baseline clip it was re-encoded from, bitwise (its frames
    are the same bytes), and the tables of process_frames on its natively
    decoded frames; neither clip goes to cv2's stream."""
    from opticalflowclustering_tpu_torch.features.grid import GridParams
    from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams
    from opticalflowclustering_tpu_torch.io import video as io_video

    def no_cv2(*args, **kwargs):
        raise AssertionError("an MJPEG AVI went to cv2's stream")

    monkeypatch.setattr(io_video, "stream_video_chunks", no_cv2)
    cfg = tpl.PipelineConfig(grid=GridParams(rows=4, cols=5), flow=FarnebackParams(warp_mode="fast", levels=2),
                             chunk=4, emit_flow_bgr=False)
    prog, base = _sin_clip_avi(tmp_path, True), _sin_clip_avi(tmp_path, False)
    got = tpl.process_video_stream(prog, cfg, native=True, device="cpu")
    want = tpl.process_video_stream(base, cfg, native=True, device="cpu")
    frames = tpl.process_frames(fastio.decode_mjpeg_avi(prog), cfg, device="cpu")
    assert got["hue_table"].shape == (8, 20)
    for k in ("hue_table", "rgb_hue_table", "centroids", "mean_magnitude"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], frames[k], err_msg=k)
