"""PyTorch port vs the JAX package: arithmetic-coded JPEG frames, sequential
(SOF9) and progressive (SOF10), in the port's native MJPEG decoder
(opticalflowclustering_tpu_torch.io.fastio over its own native/fastio.cpp ↔
opticalflowclustering_tpu.io.fastio over libjpeg-turbo 2.1.5, JCS_EXT_BGR, no
fancy upsampling, ISLOW IDCT, block smoothing on).

No encoder on hand writes these frames (cv2 and PIL do not), so the inputs
are committed under tests/golden/torch_arith/: baseline JPEGs and their
coefficients re-coded with arithmetic coding by libjpeg (make_fixtures.py
there says how they were made and remakes them). Only the entropy coding
differs, so a whole re-coding decodes to the bytes of its baseline source,
and the demo clip's re-codings to those of demo_out/601_3.avi. Damaged
frames are built here from the committed ones; the oracle for them is the
sha256 of the JAX decoder's output, pinned below, so the cases count on any
host. The arithmetic decoder's rules differ from the Huffman one's where the
data is bad: past a marker it goes on decoding zero bytes (a cut frame is
garbage to its end, not grey), and after a bad code (a magnitude or a run
past the band) it skips the rest of the restart interval."""

import pathlib
import re
import tempfile

import numpy as np
import pytest
import torch

from opticalflowclustering_tpu.io import fastio as jfastio
from opticalflowclustering_tpu_torch.io import fastio
from opticalflowclustering_tpu_torch.io.video import read_video_bgr
from opticalflowclustering_tpu_torch.pipeline import bounce as tpl
from test_torch_fastio import DEMO, _avi, _digest
from test_torch_fastio_progressive import _scans

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden" / "torch_arith"
DEMO_CLIPS = {"sof9": GOLDEN / "demo_sof9.avi", "sof10": GOLDEN / "demo_sof10.avi"}


# ---------------------------------------------------------------- inputs ----

def _fixture(name):
    return (GOLDEN / name).read_bytes()


def _sof(jpeg):
    """The frame's SOF marker."""
    return re.search(rb"\xff([\xc0-\xc3\xc5-\xc7\xc9-\xcb\xcd-\xcf])", jpeg).group(1)[0]


# every committed re-coding, by file name; each has its baseline source
# <case>.jpg beside it
WHOLE = sorted(p.name for p in GOLDEN.glob("*.sof*.jpg"))


def _source(name):
    return name.split(".")[0] + ".jpg"


def _cut(name, scan, at=0.5):
    """The frame cut a fraction `at` into the data of scan `scan` (1-based)."""
    j = _fixture(name)
    _, lo, hi = _scans(j)[scan - 1]
    return j[: lo + int((hi - lo) * at)]


def _flipped(name, at, mask, scan):
    """Byte `at` of the frame xor `mask`; it lies in the data of scan `scan`."""
    j = bytearray(_fixture(name))
    _, lo, hi = _scans(bytes(j))[scan - 1]
    assert lo <= at < hi
    j[at] ^= mask
    return bytes(j)


def _lost_restart(name, scan):
    """The fourth RST marker of scan `scan` gone."""
    j = _fixture(name)
    _, lo, hi = _scans(j)[scan - 1]
    at = lo + [m.start() for m in re.finditer(rb"\xff[\xd0-\xd7]", j[lo:hi])][3]
    return j[:at] + j[at + 2 :]


def _dac(name, before_scan, pair, index=None, value=None):
    """The frame with pair `pair` of the DAC segment right before scan
    `before_scan` (1-based) set to (index, value), where given."""
    j = bytearray(_fixture(name))
    head = _scans(bytes(j))[before_scan - 1][0]
    at = j.rindex(b"\xff\xcc", 0, head) + 4 + 2 * pair
    assert at + 2 <= head
    if index is not None:
        j[at] = index
    if value is not None:
        j[at + 1] = value
    return bytes(j)


def _with_dht(name):
    """A DHT segment (Annex K's DC luma table) before the frame's SOS: an
    arithmetic frame reads it and uses no table of it."""
    j = _fixture(name)
    dht = bytes([0xFF, 0xC4, 0, 31, 0x00, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, *range(12)])
    at = j.index(b"\xff\xda")
    return j[:at] + dht + j[at:]


def _sos_as_dqt(name, scan):
    """Scan `scan`'s SOS marker turned into a DQT: its 6-byte header is read
    as a table of 64 entries, which libjpeg-turbo refuses for its length."""
    j = bytearray(_fixture(name))
    head = _scans(bytes(j))[scan - 1][0]
    j[head + 1] = 0xDB
    return bytes(j)


# Damaged frames: a one-frame AVI of each.
DAMAGED = {
    # SOF9 cut short: it decodes zero bytes to its end
    **{f"sof9_cut_{int(f * 100)}pct": (lambda f=f: _cut("420_q75.sof9.jpg", 1, f)) for f in (0.3, 0.6, 0.9)},
    # SOF10 cut inside each of its ten scans: the smoothing of the blocks
    # takes the coefficient bits the cut scan had begun with or given
    **{f"sof10_cut_in_scan{s}": (lambda s=s: _cut("420_q75.sof10.jpg", s)) for s in range(1, 11)},
    "sof10_720p_cut_in_scan5": lambda: _cut("demo30_720p_q90.sof10.jpg", 5),
    # a flipped byte that makes a bad code: the rest of the segment skipped
    "sof9_bad_code": lambda: _flipped("420_q75.sof9.jpg", 242, 0x80, 1),
    "sof9_restart1_bad_code": lambda: _flipped("420_restart1.sof9.jpg", 393, 0x10, 1),
    "sof10_bad_code_in_ac_first": lambda: _flipped("420_q75.sof10.jpg", 279, 0x80, 2),
    "sof10_bad_code_in_ac_refine": lambda: _flipped("420_q75.sof10.jpg", 502, 0x01, 6),
    "sof9_lost_restart": lambda: _lost_restart("420_restart1.sof9.jpg", 1),
    "sof10_lost_restart_in_scan6": lambda: _lost_restart("420_restart1.sof10.jpg", 6),
    # other conditioning than the frame was coded with, all legal: K = 0
    # and K > 63 (each puts every coefficient's magnitude in one set of
    # bins, so the two decode alike) and wider DC bounds
    "sof9_dac_k0": lambda: _dac("420_q75.sof9.jpg", 1, 1, value=0),
    "sof9_dac_k100": lambda: _dac("420_q75.sof9.jpg", 1, 1, value=100),
    "sof9_dac_l0_u15": lambda: _dac("420_q75.sof9.jpg", 1, 0, value=0xF0),
    "sof10_with_dht": lambda: _with_dht("420_q75.sof10.jpg"),
}

# Frames that libjpeg refuses mid-frame (rc -2): a DAC index of 32 or more,
# a DAC with L > U, a short DQT. The SOF9 ones sit in the second frame of a
# two-frame AVI (its first DAC comes before its SOS, so the first frame's
# would fail the probe); the SOF10 ones before the second scan.
REFUSED = {
    "sof9_dac_index_32": lambda: _dac("420_q75.sof9.jpg", 1, 0, index=0x20),
    "sof9_dac_l_above_u": lambda: _dac("420_q75.sof9.jpg", 1, 0, value=0x12),
    "sof10_dac_index_32": lambda: _dac("420_q75.sof10.jpg", 2, 0, index=0x20),
    "sof10_dac_l_above_u": lambda: _dac("420_q75.sof10.jpg", 2, 0, index=0x00, value=0x0F),
    "sof10_sos_as_short_dqt": lambda: _sos_as_dqt("420_q75.sof10.jpg", 2),
}


def _refused_frames(name):
    jpeg = REFUSED[name]()
    return [_fixture("420_q75.sof9.jpg"), jpeg] if _sof(jpeg) == 0xC9 else [jpeg]


# sha256 of opticalflowclustering_tpu.io.fastio.decode_mjpeg_avi (libjpeg-turbo
# 2.1.5, JCS_EXT_BGR, no fancy upsampling, ISLOW, block smoothing on) on each
# baseline source and each damaged case, made by
#   JAX_PLATFORMS=cpu python -c "import sys; sys.path[:0] = ['.', 'tests']; \
#     import test_torch_fastio_arith as t; t.print_jax_digests()"
JAX_DIGESTS = {
    "411_q60.jpg": "5b335465f2946d4c50067cd566bb70461b84fccd2be855fdfc1ebd9ccb192f5e",
    "420_dac_l2_u5_k2.jpg": "56a545bed2f99bc3ef388165f1024790a55741b737ea9c84bcccf0e0f0481011",
    "420_non_interleaved.jpg": "a02e001ea4e266b6570f9b722b3bc42ec546ce9555813605606c65bac0c955b0",
    "420_odd_37x101_q5.jpg": "ea8378ec3a6ebffd8ac6e5f808d4815c183d3c865811b39d71acec28703c6c15",
    "420_q75.jpg": "e4050dd3946fcf3e0d7db5d663afc191de266910d1f9dfd7d28e9a72af12de38",
    "420_restart1.jpg": "e10b1e94bed4207872eac9a8e085ffb0f3f96744cdde085632de7e4b46cdc6f2",
    "420_script.jpg": "c8d09ce15c14630e71deb88771ff1539332946820f3131a89fd879e2e5710980",
    "422_odd_17x23_q30.jpg": "ccc9e28a85ef8f9a9edfed5ddd96e5dff314f167165113ceef01c0c01dd95747",
    "422_q90.jpg": "2f9a6c6447824f89c23de82a97f386e06df9e237addc36b9e902a965e5efc14f",
    "422_restart3_q10.jpg": "198496938c52323e1d93ef4ca12b8c22e724cb1d4e3778282b05c90bf3de75f8",
    "444_1x1.jpg": "8e7da991ec29c41e8dcc6874d8aadb23448287b0ec5dd64e18478a2f11e5b03d",
    "444_q75.jpg": "75396962f28a18bd6ef7d5baf7ee85e0dcbca186e8e0ac820b3d27d44629411d",
    "demo29_720p_q90.jpg": "b65d5a1e765dca309946a768631221613687b8488fd4a3e60c1c4cc38be405d0",
    "demo30_720p_q90.jpg": "f4c651cda96e5db20db76ebf48abc5a0f6755861af1364b57926d74ed2803b81",
    "gray_q80.jpg": "1519dc813efe0198caf5ab28fd12d26d405c85ec6047ca7427c9a2fa34a78106",
    "sof9_cut_30pct": "4cdf8da57dfc6c50afccbd325693ffd314da333f0e80f352c568f663d8011baf",
    "sof9_cut_60pct": "6ffe8c425531c0d218a42f5813723298a0168d9e89aa5d80bd1b7994faa468e1",
    "sof9_cut_90pct": "921d0239c6082d66baaf9bc2defee67f96b6f8b9556ca768778a50fa95984fed",
    "sof10_cut_in_scan1": "40a4b5d1132ad76a122e94ef7fa88009c08cf337159c2d1ea0e30de0b66e4108",
    "sof10_cut_in_scan2": "b7c07c8821db0331c14b5e00627d5c4a799a111d6e9189998715afa294415faf",
    "sof10_cut_in_scan3": "2f99c4e850dd1a3368b9d2659613b30d1816cfde885ae7506422e75a60a11106",
    "sof10_cut_in_scan4": "111e1998dbeffbcadd3653dad68e8ed7019f7503cf893eaf610e8a7e752e57b1",
    "sof10_cut_in_scan5": "f3449d46806b84736d9faea149488e3d9b95dfffa74de3e142bf57991d61a53f",
    "sof10_cut_in_scan6": "8bde3c3879c88ea2b42ccc211630725283d60d3f6afcc097b38490f27d530f51",
    "sof10_cut_in_scan7": "0aa61b60a2b9586aa24648551849c93dad70418969c4fad7c4c08e1a4e677e60",
    "sof10_cut_in_scan8": "a93d071a92fb40d911803b277a8b0eda5ab0a92baceffb8dd7f45b6bd11c3350",
    "sof10_cut_in_scan9": "3dc3fc67f98cd5eeec84967a76a14f8b452577333ad6956871cf067cbad48ed7",
    "sof10_cut_in_scan10": "375b13fcb15476feb6b633fe77c6f50924e25b5684012bda4ba28a911eb21c97",
    "sof10_720p_cut_in_scan5": "f4eb3298472db18bb7ba930292fd595c1e31eb99480e55fb2df6e776727aa9d7",
    "sof9_bad_code": "9174a79aa125f8a3feb7d0f60dfa2016f947ae7f58c2be719749db372180905f",
    "sof9_restart1_bad_code": "47ed2394c083db0f3cd7f5f69257484c0e1cb51a520808e4cea9d89f21a50d9b",
    "sof10_bad_code_in_ac_first": "88cc8f6aea20be2263825a5f29a87317652ff57f0413410175d70e4b516ef358",
    "sof10_bad_code_in_ac_refine": "3569498a1c052b9e7ce121bb76c75799c507b2b00fc5f63d37f97ff9980476a3",
    "sof9_lost_restart": "af91e3e487e4e083615aa3eb9dd530a2626e788bd4fd19d359541cf9939bcc80",
    "sof10_lost_restart_in_scan6": "9251cbe11eca6de47e7071a4326f61c6f13564bf75d2360bf53f10ed4f0e5150",
    "sof9_dac_k0": "68520b8e4c62581168a1456c19d17a6f4a5fbe714593c4a23ef77e3cc3295c50",
    "sof9_dac_k100": "68520b8e4c62581168a1456c19d17a6f4a5fbe714593c4a23ef77e3cc3295c50",
    "sof9_dac_l0_u15": "f4cdb094f0d373aca4a7a20ab796db2668806a078e9f3c4f358ac62b3c3c8c19",
    "sof10_with_dht": "e4050dd3946fcf3e0d7db5d663afc191de266910d1f9dfd7d28e9a72af12de38",
}


def print_jax_digests():
    """Print JAX_DIGESTS anew from the JAX package's decoder."""
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "c.avi"
        for name in sorted({_source(n) for n in WHOLE}):
            print(f'    "{name}": "{_digest(jfastio.decode_mjpeg_avi(_avi(path, [_fixture(name)])))}",')
        for name, make in DAMAGED.items():
            print(f'    "{name}": "{_digest(jfastio.decode_mjpeg_avi(_avi(path, [make()])))}",')


# ---------------------------------------------------------------- tests ----

@pytest.mark.parametrize("name", WHOLE)
def test_whole_frame_decodes_to_its_baseline_source(name, tmp_path):
    """Each committed SOF9 and SOF10 re-coding (4:2:0, 4:2:2, 4:4:4, 4:1:1,
    grey, odd sizes, 1×1, restart intervals, non-default conditioning, a
    scan script of its own, three non-interleaved sequential scans, 720p
    tiles of the demo clip) decodes to the bytes of its baseline source,
    whose decode hashes to the JAX decoder's."""
    jpeg = _fixture(name)
    assert _sof(jpeg) == (0xC9 if name.endswith(".sof9.jpg") else 0xCA)
    got = fastio.decode_mjpeg_avi(_avi(tmp_path / "a.avi", [jpeg]))
    base = fastio.decode_mjpeg_avi(_avi(tmp_path / "b.avi", [_fixture(_source(name))]))
    assert _digest(base) == JAX_DIGESTS[_source(name)]
    np.testing.assert_array_equal(got, base)


@pytest.mark.parametrize("case", [*DAMAGED])
def test_damaged_frame_is_bitwise_the_jax_decoders(case, tmp_path):
    """Each damaged arithmetic frame: the port's decode against the pinned
    digest of the JAX decoder's."""
    got = fastio.decode_mjpeg_avi(_avi(tmp_path / "d.avi", [DAMAGED[case]()]))
    assert got.dtype == np.uint8 and got.shape[0] == 1
    assert _digest(got) == JAX_DIGESTS[case]


@pytest.mark.parametrize("case", [*REFUSED])
def test_refused_frames_fail_with_rc_2(case, tmp_path):
    """A DAC with an index of 32 or more or with L > U, and a DQT shorter
    than its 64 entries, fail the frame as libjpeg's error exit does: rc -2,
    from the batch and from the stream, as in the JAX decoder."""
    path = _avi(tmp_path / "bad.avi", _refused_frames(case))
    assert fastio.probe_mjpeg_avi(path) is not None
    with pytest.raises(ValueError, match=r"mjpeg decode failed \(rc=-2\)"):
        fastio.decode_mjpeg_avi(path)
    with pytest.raises(ValueError, match=r"mjpeg stream decode failed \(rc=-2\)"):
        list(fastio.stream_mjpeg_avi(path, 1))
    if jfastio.available():
        with pytest.raises(ValueError, match=r"mjpeg decode failed \(rc=-2\)"):
            jfastio.decode_mjpeg_avi(path)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("kind", [*DEMO_CLIPS])
def test_demo_clip_decodes_to_the_demo_clips_bytes(kind, threads):
    """The demo clip's 75 frames, each re-coded: the batch decode at 1 and 4
    threads, read_video_bgr(native=True), a prefix (max_frames) and the
    stream in windows that start mid-clip give the bytes of
    demo_out/601_3.avi."""
    path = str(DEMO_CLIPS[kind])
    want = fastio.decode_mjpeg_avi(DEMO, threads=threads)
    assert fastio.probe_mjpeg_avi(path) == (75, 232, 220)
    np.testing.assert_array_equal(fastio.decode_mjpeg_avi(path, threads=threads), want)
    np.testing.assert_array_equal(fastio.decode_mjpeg_avi(path, max_frames=13, threads=threads), want[:13])
    chunks = [c[:n] for c, n in fastio.stream_mjpeg_avi(path, chunk=7, overlap=0, max_frames=40, segment=16)]
    np.testing.assert_array_equal(np.concatenate(chunks), want[:40])
    if threads == 1:
        np.testing.assert_array_equal(read_video_bgr(path, native=True), want)


@pytest.mark.parametrize("kind", [*DEMO_CLIPS])
def test_demo_clip_streams_to_the_demo_clips_tables(kind, monkeypatch):
    """process_video_stream(native=True) on a re-coded demo clip gives the
    tables of demo_out/601_3.avi's native stream bitwise, and neither clip
    goes to cv2's stream."""
    from opticalflowclustering_tpu_torch.features.grid import GridParams
    from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams
    from opticalflowclustering_tpu_torch.io import video as io_video

    def no_cv2(*args, **kwargs):
        raise AssertionError("an MJPEG AVI went to cv2's stream")

    monkeypatch.setattr(io_video, "stream_video_chunks", no_cv2)
    cfg = tpl.PipelineConfig(grid=GridParams(rows=4, cols=5), flow=FarnebackParams(warp_mode="fast", levels=2),
                             chunk=8, emit_flow_bgr=False)
    got = tpl.process_video_stream(str(DEMO_CLIPS[kind]), cfg, 24, True, device="cpu")
    want = tpl.process_video_stream(DEMO, cfg, 24, True, device="cpu")
    assert got["hue_table"].shape == (23, 20)
    for k in ("hue_table", "rgb_hue_table", "centroids", "mean_magnitude"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_every_fixture_against_the_jax_decoder_live(tmp_path):
    """The JAX decoder itself over every committed fixture and damaged case,
    where its library builds (it links libjpeg, which the card's machine
    lacks)."""
    if not jfastio.available():
        pytest.skip("the JAX package's native decoder does not build here")
    inputs = {n: [_fixture(n)] for n in WHOLE} | {n: [make()] for n, make in DAMAGED.items()}
    for name, frames in inputs.items():
        path = _avi(tmp_path / "l.avi", frames)
        np.testing.assert_array_equal(fastio.decode_mjpeg_avi(path), jfastio.decode_mjpeg_avi(path), err_msg=name)
    for kind, clip in DEMO_CLIPS.items():
        np.testing.assert_array_equal(fastio.decode_mjpeg_avi(str(clip)), jfastio.decode_mjpeg_avi(str(clip)),
                                      err_msg=kind)
