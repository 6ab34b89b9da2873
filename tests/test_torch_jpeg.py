"""The port's JPEG decoder (``data/jpeg.py`` over ``csrc/jpeg_decode.cpp``)
against OpenCV: every decode equal, bit for bit, to
``cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)`` on
seeded encodings (chroma subsamplings, grayscale, restart intervals,
optimized Huffman tables, sizes that are not multiples of the MCU) and on
the committed eval fixture, whose manifest hashes it must also give; EXIF
orientations as ``imread`` applies them; and the kinds it does not decode
refused with a ``ValueError`` naming the file."""

import hashlib
import json
import os
import struct

import numpy as np
import pytest

from litepose_tpu_torch.data.jpeg import decode_jpeg, exif_orientation, jpeg_size

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "litepose_tpu_torch", "assets", "eval_fixture")
SIZES = [(1, 1), (2, 3), (7, 17), (31, 45), (48, 64), (61, 83)]


def _cv2_rgb(data: bytes) -> np.ndarray:
    import cv2

    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _image(rng, h, w):
    """Smooth gradients plus noise and a few hard edges: every coefficient
    band carries energy."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255.0 / max(w, 1), y * 255.0 / max(h, 1), (x + y) % 37 * 6.0], -1)
    img = base + rng.normal(0, 25, (h, w, 3))
    img[h // 3:, w // 2:] = 255 - img[h // 3:, w // 2:]
    return np.clip(img, 0, 255).astype(np.uint8)


ENCODINGS = {
    "420": {"SAMPLING_FACTOR": "420"}, "422": {"SAMPLING_FACTOR": "422"},
    "444": {"SAMPLING_FACTOR": "444"}, "440": {"SAMPLING_FACTOR": "440"},
    "411": {"SAMPLING_FACTOR": "411"}, "gray": {"GRAY": True},
    "420 restart 1": {"RST_INTERVAL": 1}, "444 restart 7": {"SAMPLING_FACTOR": "444",
                                                             "RST_INTERVAL": 7},
    "gray restart 2": {"GRAY": True, "RST_INTERVAL": 2},
    "420 optimized q95": {"OPTIMIZE": 1, "QUALITY": 95}, "422 q10": {"SAMPLING_FACTOR": "422",
                                                                     "QUALITY": 10},
    "420 q100": {"QUALITY": 100},
}


def _encode(rgb, spec):
    import cv2

    params = [cv2.IMWRITE_JPEG_QUALITY, spec.get("QUALITY", 80)]
    if "RST_INTERVAL" in spec:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, spec["RST_INTERVAL"]]
    if "OPTIMIZE" in spec:
        params += [cv2.IMWRITE_JPEG_OPTIMIZE, spec["OPTIMIZE"]]
    if spec.get("GRAY"):
        pixels = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
    else:
        pixels = cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)
        factor = getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + spec.get("SAMPLING_FACTOR", "420"))
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor]
    ok, buf = cv2.imencode(".jpg", pixels, params)
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("encoding", list(ENCODINGS))
def test_decode_equals_cv2(encoding):
    rng = np.random.default_rng(list(ENCODINGS).index(encoding))
    for h, w in SIZES + [(427, 640)]:
        data = _encode(_image(rng, h, w), ENCODINGS[encoding])
        got = decode_jpeg(data)
        want = _cv2_rgb(data)
        assert got.shape == want.shape == (h, w, 3)
        assert np.array_equal(got, want), (encoding, h, w, int(np.abs(
            got.astype(int) - want).max()))


def test_committed_fixture_equals_cv2_and_manifest():
    import cv2

    with open(os.path.join(FIXTURE, "manifest.json")) as f:
        manifest = json.load(f)["images"]
    assert len(manifest) == 12
    assert sum(os.path.getsize(os.path.join(FIXTURE, m["file_name"])) for m in manifest) < 1.1e6
    encodings = set()
    for m in manifest:
        path = os.path.join(FIXTURE, m["file_name"])
        got = decode_jpeg(path)
        want = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        assert np.array_equal(got, want), m["file_name"]
        assert hashlib.sha256(got.tobytes()).hexdigest() == m["sha256_rgb"], m["file_name"]
        assert jpeg_size(path) == (m["height"], m["width"]) == got.shape[:2]
        encodings.update(m["encoding"].split())
    assert {"420", "422", "444", "gray", "restart", "exif"} <= encodings
    assert any(m["height"] % 16 for m in manifest)


def _app1(orientation, endian):
    e = "<" if endian == "II" else ">"
    tiff = (endian.encode() + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0))
    payload = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


@pytest.mark.parametrize("endian", ["II", "MM"])
def test_exif_orientation_as_imread(tmp_path, endian):
    import cv2

    data = _encode(_image(np.random.default_rng(4), 21, 34), {})
    for orientation in range(0, 10):
        path = tmp_path / f"o{orientation}.jpg"
        path.write_bytes(data[:2] + _app1(orientation, endian) + data[2:])
        want = cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        got = decode_jpeg(str(path))
        assert np.array_equal(got, want), orientation
        assert jpeg_size(str(path)) == want.shape[:2]
        assert exif_orientation(path.read_bytes()) == (orientation if 1 <= orientation <= 8
                                                       else 1)


def _sof_offset(data: bytes) -> int:
    """Offset of the SOF0 marker's 0xC0 byte."""
    i = data.index(b"\xff\xc0")
    return i + 1


def test_refused_kinds_name_the_file(tmp_path):
    import cv2

    rgb = _image(np.random.default_rng(5), 24, 40)
    ok, buf = cv2.imencode(".jpg", rgb, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    path = tmp_path / "progressive.jpg"
    path.write_bytes(buf.tobytes())
    with pytest.raises(ValueError, match="progressive.jpg: progressive"):
        decode_jpeg(str(path))
    assert jpeg_size(str(path)) == (24, 40)  # the header still reads

    base = _encode(rgb, {})
    at = _sof_offset(base)
    cases = {
        "arithmetic.jpg": (base[:at] + b"\xc9" + base[at + 1:], "arithmetic-coded"),
        "twelve_bit.jpg": (base[:at + 3] + b"\x0c" + base[at + 4:], "12-bit"),
        "lossless.jpg": (base[:at] + b"\xc3" + base[at + 1:], "lossless"),
        "not_a_jpeg.jpg": (b"\x89PNG\r\n\x1a\n" + base, "not a JPEG"),
    }
    # a CMYK frame header: four components
    sof = bytes([0xFF, 0xC0]) + struct.pack(">HBHHB", 8 + 12, 8, 24, 40, 4) + bytes(
        [1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1, 4, 0x11, 0])
    cases["cmyk.jpg"] = (b"\xff\xd8" + sof + b"\xff\xd9", "4-component")
    for name, (data, what) in cases.items():
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(ValueError, match=f"{name}: .*{what}"):
            decode_jpeg(str(path))


@pytest.mark.parametrize("encoding", ["420", "gray", "420 restart 1"])
def test_truncated_file_raises_where_imread_gives_nothing(encoding):
    """A scan cut short: libjpeg would feed zeros past the end and warn,
    and OpenCV's imread then returns no image; the decoder raises."""
    import cv2

    data = _encode(_image(np.random.default_rng(6), 61, 83), ENCODINGS[encoding])
    for cut in (0.5, 0.9):
        short = data[:int(len(data) * cut)]
        assert cv2.imdecode(np.frombuffer(short, np.uint8), cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match="corrupt or truncated"):
            decode_jpeg(short)



def _with_dht(data: bytes, table: int, counts, vals) -> bytes:
    """``data`` with one more DHT segment before its scan: ``table`` is the
    Tc/Th byte (0x00 the DC table 0, 0x10 the AC table 0)."""
    body = bytes([table]) + bytes(counts) + bytes(vals)
    seg = b"\xff\xc4" + struct.pack(">H", len(body) + 2) + body
    at = data.index(b"\xff\xda")
    return data[:at] + seg + data[at:]


def _counts(*pairs):
    """The 16 code counts from (length, count) pairs."""
    counts = [0] * 16
    for length, n in pairs:
        counts[length - 1] = n
    return counts


# Tc/Th, code counts, symbols
BAD_TABLES = {
    "3 codes of length 1": (0x00, _counts((1, 3)), [0, 1, 2]),
    "255 codes of length 1": (0x00, _counts((1, 255)), [k % 12 for k in range(255)]),
    "over-subscribed at length 9": (0x10, _counts((1, 1), (2, 1), (9, 254)), range(256)),
    "all-ones code of length 1": (0x00, _counts((1, 2)), [0, 1]),
    "all-ones code of length 16": (0x10, _counts(*[(n, 1) for n in range(1, 16)], (16, 2)),
                                   range(17)),
    "DC symbol above 15": (0x00, _counts((2, 1)), [16]),
}


@pytest.mark.parametrize("case", list(BAD_TABLES))
def test_bad_huffman_table_refused_as_libjpeg(case):
    """A Huffman table that libjpeg refuses when the scan uses it: code
    counts that over-subscribe a length (once a write past the decoder's
    9-bit lookup table), a code of all ones, a DC symbol above 15. The
    decoder raises where ``imdecode`` gives no image."""
    import cv2

    table, counts, vals = BAD_TABLES[case]
    data = _with_dht(_encode(_image(np.random.default_rng(7), 31, 45), {}), table, counts,
                     list(vals))
    assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match="corrupt or truncated"):
        decode_jpeg(data)


def test_bad_huffman_table_unused_by_the_scan_decodes_as_cv2():
    """libjpeg checks a table only when a scan uses it: an over-subscribed AC
    table 3 that no component selects leaves the image as ``imread`` gives
    it."""
    data = _encode(_image(np.random.default_rng(8), 31, 45), {})
    bad = _with_dht(data, 0x13, _counts((1, 255)), list(range(255)))
    assert np.array_equal(decode_jpeg(bad), _cv2_rgb(bad))
    assert np.array_equal(decode_jpeg(bad), decode_jpeg(data))
