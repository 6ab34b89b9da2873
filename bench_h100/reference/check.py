"""The comparison that decides ``correct`` for a serving cell.

Three numbers, each against the configuration's limit:

- ``det_rel_rms`` and ``tag_rel_rms``: the program's heatmaps and tag maps,
  as the engine aggregated them in the timed calls, against the fp32
  reference forward of the same images: ``||program - reference|| /
  ||reference||`` over all checked images;
- ``decode_mismatch``: the checked images whose people, scores or count,
  as the timed calls returned them, differ in any bit from the reference
  decode of the program's own maps.  The decode is judged on the maps the
  program made, since its peaks are discrete; the maps are judged on their
  own by the two numbers above.

``control_outputs`` gives what the control puts in the program's place:
the reference forward in fp8 and its decode in bf16.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .decode import decode
from .litepose import Reference, fp32_exact

BLOCK = 16


def numbers(ref: Reference, cfg: Dict, images: np.ndarray, det: torch.Tensor,
            tag: torch.Tensor, people: np.ndarray, scores: np.ndarray,
            counts: np.ndarray) -> Dict[str, float]:
    """The three numbers for N checked images: images (N, H, W, 3) uint8,
    det (N, J, h, w) and tag (N, J, 1, h, w) as the program made them (any
    float dtype, any device), people, scores, counts as it returned them."""
    sums = np.zeros(4)
    mismatch = 0
    with fp32_exact(), torch.no_grad():
        for lo in range(0, len(images), BLOCK):
            hi = min(lo + BLOCK, len(images))
            det_r, tag_r = ref.maps(torch.from_numpy(images[lo:hi]))
            d = det[lo:hi].to(ref.device).float()
            t = tag[lo:hi].to(ref.device).float()
            for i, (a, r) in enumerate(((d, det_r), (t, tag_r))):
                diff = a.double() - r.double()
                sums[2 * i] += float((diff * diff).sum())
                sums[2 * i + 1] += float((r.double() ** 2).sum())
            p, s, n = (x.cpu().numpy() for x in decode(d, t, cfg))
            for b in range(hi - lo):
                same = (np.array_equal(p[b], people[lo + b])
                        and np.array_equal(s[b], scores[lo + b])
                        and int(n[b]) == int(counts[lo + b]))
                mismatch += not same
    return {"det_rel_rms": float(np.sqrt(sums[0] / sums[1])),
            "tag_rel_rms": float(np.sqrt(sums[2] / sums[3])),
            "decode_mismatch": float(mismatch)}


def control_outputs(control: Reference, cfg: Dict, images: np.ndarray
                    ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray, np.ndarray, np.ndarray]:
    """The control in the program's place: maps of the fp8 forward, people
    of the bf16 decode."""
    dets: List[torch.Tensor] = []
    tags: List[torch.Tensor] = []
    outs: List[Tuple[np.ndarray, ...]] = []
    with fp32_exact(), torch.no_grad():
        for lo in range(0, len(images), BLOCK):
            d, t = control.maps(torch.from_numpy(images[lo:lo + BLOCK]))
            dets.append(d)
            tags.append(t)
            outs.append(tuple(x.cpu().numpy() for x in decode(d, t, cfg, precision="bf16")))
    return (torch.cat(dets), torch.cat(tags),
            *(np.concatenate([o[i] for o in outs]) for i in range(3)))
