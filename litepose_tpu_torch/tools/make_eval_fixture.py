"""Write the committed eval fixture: 12 synthetic CrowdPose-style scenes as
JPEGs in several encodings, their COCO-format annotations and a manifest
of cv2's decodes.

    python -m litepose_tpu_torch.tools.make_eval_fixture \\
        [--out litepose_tpu_torch/assets/eval_fixture]

It runs only where OpenCV (cv2) is installed: cv2 encodes the files and
decodes them for the manifest's ``sha256`` (of the RGB bytes of
``cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)``),
which the port's own decoder (``data/jpeg.py``) must reproduce wherever it
runs.  Nothing else in the port imports cv2.

The scenes are stick-figure people on dark noise drawn by
``data/synthetic.py`` (the scenes the bench checkpoints were fitted to),
at CrowdPose's image sizes; the encodings cover 4:2:0 (cv2's default),
4:2:2, 4:4:4, grayscale, restart intervals, a height that is not a
multiple of 16, and one file stored rotated with a hand-written EXIF APP1
(orientation 6) that the decoder must undo.  The annotations follow
``make_fixture`` (``litepose_tpu/data/synthetic.py``): every person with 14
visible joints, a box polygon and its area, plus a crowd region (RLE) and
a keypoint-less person, and a ``crowdIndex`` per image spanning
CrowdPose's easy, medium and hard buckets.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import struct

import numpy as np

from ..data.synthetic import draw_person, person_keypoints

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "assets", "eval_fixture")
NUM_JOINTS = 14
QUALITY = 75
# (height, width, encoding) of each scene as it is displayed
SCENES = (
    (427, 640, "420"), (512, 512, "420"), (427, 640, "gray"), (512, 512, "422"),
    (427, 640, "420 exif 6"), (480, 640, "420"), (640, 480, "420 restart 5"),
    (480, 640, "444"), (640, 480, "444 restart 1"), (512, 512, "gray restart 3"),
    (427, 640, "422 restart 2"), (640, 480, "420"),
)


def exif_app1(orientation: int) -> bytes:
    """An APP1 segment holding a little-endian TIFF IFD0 with one entry,
    the orientation (tag 0x0112, SHORT)."""
    tiff = (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0))
    payload = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


def rle_counts(mask: np.ndarray) -> list:
    """Column-major uncompressed RLE counts of a binary mask (runs of 0s first)."""
    flat = np.asarray(mask, np.uint8).T.reshape(-1)
    change = np.flatnonzero(np.diff(flat)) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).tolist()
    return ([0] + counts) if flat[0] else counts


def scene(rng, h: int, w: int):
    """(RGB image, people (num_joints, 3) each)."""
    img = rng.uniform(0, 60, (h, w, 3)).astype(np.uint8)
    people = []
    for _ in range(int(rng.integers(1, 5))):
        cx, cy = rng.uniform(40, w - 40), rng.uniform(40, h - 40)
        size = rng.uniform(30, 100) * min(h, w) / 512.0
        pts = person_keypoints(rng, cx, cy, size, NUM_JOINTS)
        draw_person(img, pts)
        people.append(pts)
    return img, people


def encode(cv2, rgb: np.ndarray, encoding: str) -> bytes:
    parts = encoding.split()
    params = [cv2.IMWRITE_JPEG_QUALITY, QUALITY]
    if "restart" in parts:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, int(parts[parts.index("restart") + 1])]
    if parts[0] == "gray":
        pixels = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
    else:
        pixels = cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, {
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}[parts[0]]]
    ok, buf = cv2.imencode(".jpg", pixels, params)
    if not ok:
        raise RuntimeError(f"cv2 could not encode {encoding}")
    return buf.tobytes()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    try:
        import cv2
    except ImportError as e:
        raise SystemExit("make_eval_fixture needs OpenCV (cv2), which encodes the files and "
                         "decodes them for the manifest; run it where cv2 is installed") from e

    rng = np.random.default_rng(args.seed)
    os.makedirs(args.out, exist_ok=True)
    images, annotations, manifest = [], [], []
    ann_id = 1
    for i, (h, w, encoding) in enumerate(SCENES):
        rgb, people = scene(rng, h, w)
        name = f"{i:06d}.jpg"
        if "exif" in encoding:
            # stored as transpose(fliplr(scene)); orientation 6 (transpose,
            # then a horizontal flip) shows the scene
            stored = np.ascontiguousarray(rgb[:, ::-1].transpose(1, 0, 2))
            data = encode(cv2, stored, encoding.split()[0])
            data = data[:2] + exif_app1(6) + data[2:]
        else:
            data = encode(cv2, rgb, encoding)
        path = os.path.join(args.out, name)
        with open(path, "wb") as f:
            f.write(data)
        decoded = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        if decoded.shape != (h, w, 3):
            raise RuntimeError(f"{name}: cv2 decodes {decoded.shape}, expected {(h, w, 3)}")
        manifest.append({"file_name": name, "height": h, "width": w, "encoding": encoding,
                         "bytes": len(data),
                         "sha256_rgb": hashlib.sha256(decoded.tobytes()).hexdigest()})
        images.append({"id": i + 1, "file_name": name, "height": h, "width": w,
                       "crowdIndex": round(i / len(SCENES), 4)})
        for pts in people:
            x0, y0 = pts[:, 0].min(), pts[:, 1].min()
            x1, y1 = pts[:, 0].max(), pts[:, 1].max()
            bbox = [float(x0), float(y0), float(x1 - x0), float(y1 - y0)]
            annotations.append({
                "id": ann_id, "image_id": i + 1, "category_id": 1,
                "keypoints": [float(v) for v in pts.reshape(-1)],
                "num_keypoints": NUM_JOINTS, "bbox": bbox, "area": float(bbox[2] * bbox[3]),
                "iscrowd": 0,
                "segmentation": [[float(v) for v in (x0, y0, x1, y0, x1, y1, x0, y1)]],
            })
            ann_id += 1
        if i % 4 == 1:  # a crowd region (RLE)
            m = np.zeros((h, w), np.uint8)
            m[10:60, 20:120] = 1
            annotations.append({
                "id": ann_id, "image_id": i + 1, "category_id": 1,
                "keypoints": [0] * (NUM_JOINTS * 3), "num_keypoints": 0,
                "bbox": [20, 10, 100, 50], "area": 5000.0, "iscrowd": 1,
                "segmentation": {"size": [h, w], "counts": rle_counts(m)},
            })
            ann_id += 1
        if i % 4 == 2:  # a keypoint-less person (polygon)
            annotations.append({
                "id": ann_id, "image_id": i + 1, "category_id": 1,
                "keypoints": [0] * (NUM_JOINTS * 3), "num_keypoints": 0,
                "bbox": [w - 90, h - 70, 60, 40], "area": 2400.0, "iscrowd": 0,
                "segmentation": [[w - 90, h - 70, w - 30, h - 70, w - 30, h - 30, w - 90, h - 30]],
            })
            ann_id += 1
    ann = {"images": images, "annotations": annotations,
           "categories": [{"id": 1, "name": "person",
                           "keypoints": [str(j) for j in range(NUM_JOINTS)]}]}
    with open(os.path.join(args.out, "annotations.json"), "w") as f:
        json.dump(ann, f)
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump({"decoder": f"cv2 {cv2.__version__} imread(IMREAD_COLOR) -> RGB",
                   "images": manifest}, f, indent=1)
    total = sum(m["bytes"] for m in manifest)
    print(f"wrote {len(manifest)} images ({total} bytes) and {len(annotations)} annotations "
          f"to {args.out}")


if __name__ == "__main__":
    main()
