"""Missing-joint refinement (K4; counterpart of ``litepose_tpu/ops/pallas_refine.py``).

``refine_argmax`` launches ``csrc/refine_argmax.cu`` for CUDA tensors and
runs its plain twin ``refine_argmax_ref`` for CPU tensors: for every needed
(image, joint, person slot), the flat argmax of ``det - rint(tt)`` with
``tt`` the tag distance to the person's mean tag.  ``refine_batch`` keeps
the small epilogue in torch, as the TPU version keeps it in XLA: per-person
mean tags, the ``need`` mask, the gather, the quarter-pixel shift and the
fill.  Its oracle is the unpredicated per-person ``ops.group.refine``.
"""

from __future__ import annotations

import torch

HUGE_I = 2**31 - 1


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as ``__fsqrt_rn`` in the
    kernels, CUDA's ``torch.sqrt`` and ``jnp.sqrt`` give it.  PyTorch's CPU
    ``torch.sqrt`` of float32 is not on every host (on AVX512 some results
    lie one ulp off); the float64 root rounded to float32 is."""
    return torch.sqrt(x.double()).to(x.dtype)


def _tag_distance(tag: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """tag (n, T, H, W), prev (n, T) -> (n, H, W): |d| for T = 1, else
    sqrt(d0*d0 + d1*d1 + ...) with one rounding per multiply and add."""
    d = tag - prev[:, :, None, None]
    if d.shape[1] == 1:
        return d[:, 0].abs()
    acc = d[:, 0] * d[:, 0]
    for t in range(1, d.shape[1]):
        acc = acc + d[:, t] * d[:, t]
    return sqrt_rn(acc)


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """(n, L) -> (n,) int64: the lowest index among the maxima of each row."""
    idx = torch.arange(x.shape[1], device=x.device)
    best = x.amax(dim=1, keepdim=True)
    return torch.where(x == best, idx, x.shape[1]).amin(dim=1)


def refine_argmax_ref(need: torch.Tensor, prev: torch.Tensor, det: torch.Tensor,
                      tag: torch.Tensor) -> torch.Tensor:
    """Plain twin of the K4 kernel.

    need (B, K, P) int32, prev (B, P, T) f32, det (B, K, H, W) f32,
    tag (B, K, T, H, W) f32 -> pos (B, K, P) int32: the flat row-major
    argmax of ``det - rint(tt)`` (ties to the lowest index) where need is
    set, 0 elsewhere."""
    B, K, H, W = det.shape
    P = need.shape[2]
    pos = torch.zeros((B, K, P), dtype=torch.int32, device=det.device)
    for p in range(P):
        b, k = need[:, :, p].nonzero(as_tuple=True)
        if b.numel() == 0:
            continue
        penal = det[b, k] - torch.round(_tag_distance(tag[b, k], prev[b, p]))
        pos[b, k, p] = first_argmax(penal.reshape(-1, H * W)).to(torch.int32)
    return pos


def refine_argmax(need: torch.Tensor, prev: torch.Tensor, det: torch.Tensor,
                  tag: torch.Tensor) -> torch.Tensor:
    """Penalized argmax of every needed (image, joint, person slot): see
    ``refine_argmax_ref``.  A CPU tensor takes the plain twin; a CUDA tensor
    launches the kernel (``refine_argmax.launches`` counts those launches)."""
    if det.dim() != 4 or tag.dim() != 5 or need.dim() != 3 or prev.dim() != 3:
        raise ValueError(f"expected need (B,K,P), prev (B,P,T), det (B,K,H,W), "
                         f"tag (B,K,T,H,W), got {tuple(need.shape)}, "
                         f"{tuple(prev.shape)}, {tuple(det.shape)}, {tuple(tag.shape)}")
    B, K, H, W = det.shape
    P, T = prev.shape[1], prev.shape[2]
    if (tuple(need.shape) != (B, K, P) or tuple(prev.shape) != (B, P, T)
            or tuple(tag.shape) != (B, K, T, H, W)):
        raise ValueError(f"inconsistent shapes: need {tuple(need.shape)}, prev "
                         f"{tuple(prev.shape)}, det {tuple(det.shape)}, tag {tuple(tag.shape)}")
    if det.dtype != torch.float32 or tag.dtype != torch.float32 \
            or prev.dtype != torch.float32 or need.dtype != torch.int32:
        raise TypeError("det, tag and prev must be float32 and need int32")
    devices = {t.device for t in (need, prev, det, tag)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must lie on one device, got {devices}")
    if det.device.type == "cpu":
        return refine_argmax_ref(need, prev, det, tag)
    if det.device.type != "cuda":
        raise ValueError(f"refine_argmax runs on cpu or cuda, not {det.device}")
    if T not in (1, 2):
        raise ValueError(f"the kernel takes tag dim 1 or 2, got {T}")
    if H * W >= HUGE_I:
        raise ValueError(f"plane of {H}x{W} pixels overflows int32 indices")
    if B * K > 65535:
        raise ValueError(f"the kernel's grid takes at most 65535 planes, got {B * K}")
    if not all(t.is_contiguous() for t in (need, prev, det, tag)):
        raise ValueError("need, prev, det and tag must be contiguous")

    from ..kernels import build

    lib = build.load()
    pos = torch.empty((B, K, P), dtype=torch.int32, device=det.device)
    if B * K and P:
        # per (plane, slot) the max of a 64-bit (penalty, -index) key
        best = torch.zeros((B, K, P), dtype=torch.int64, device=det.device)
        vec = (H * W) % 4 == 0 and det.data_ptr() % 16 == 0 and tag.data_ptr() % 16 == 0
        err = lib.lp_refine_argmax(
            need.data_ptr(), prev.data_ptr(), det.data_ptr(), tag.data_ptr(),
            best.data_ptr(), pos.data_ptr(), B, K, P, T, H * W, int(vec),
            torch.cuda.current_stream(det.device).cuda_stream)
        build.check(err, "refine_argmax")
        refine_argmax.launches += 1
    return pos


refine_argmax.launches = 0


def person_mean_tags(people: torch.Tensor, tag: torch.Tensor):
    """Mean tag of each person over its detected joints.

    people (B, P, K, 3+T), tag (B, K, T, H, W) -> (prev (B, P, T) f32,
    sel (B, P, K) bool: joints with a score).  The joints are summed one by
    one in index order and the count divides as a tensor, as in the JAX
    ``refine_batch`` (a division by a Python scalar is a product with its
    reciprocal on CUDA)."""
    B, P, K, _ = people.shape
    H, W = tag.shape[-2:]
    sel = people[..., 2] > 0
    xi = torch.clamp(people[..., 0].long(), 0, W - 1)
    yi = torch.clamp(people[..., 1].long(), 0, H - 1)
    bb = torch.arange(B, device=tag.device)[:, None, None].expand(B, P, K)
    kk = torch.arange(K, device=tag.device)[None, None, :].expand(B, P, K)
    tags_at = torch.where(sel[..., None], tag[bb, kk, :, yi, xi], 0.0)  # (B, P, K, T)
    s = tags_at[:, :, 0]
    for k in range(1, K):
        s = s + tags_at[:, :, k]
    cnt = torch.clamp(sel.sum(-1), min=1).float()
    return s / cnt[..., None], sel


def refine_batch(people: torch.Tensor, det: torch.Tensor, tag: torch.Tensor) -> torch.Tensor:
    """Fill the missing joints of every live person from the penalized
    argmax (counterpart of ``pallas_refine.refine_batch``, "thw" layout).

    people (B, P, K, 3+T), det (B, K, H, W), tag (B, K, T, H, W) -> refined
    people; a slot with no detected joint comes back all zeros."""
    B, P, K, _ = people.shape
    H, W = det.shape[-2:]
    det = det.float().contiguous()
    tag = tag.float().contiguous()
    prev, sel = person_mean_tags(people, tag)
    exists = sel.any(-1)  # (B, P)
    # the argmax is consumed only where a live person misses the joint
    need = (exists[..., None] & ~sel).to(torch.int32)  # (B, P, K)
    pos = refine_argmax(need.transpose(1, 2).contiguous(), prev.contiguous(), det, tag)
    pos = pos.transpose(1, 2).long()  # (B, P, K); skipped slots hold 0

    py, px = pos // W, pos % W
    bb = torch.arange(B, device=det.device)[:, None, None].expand(B, P, K)
    kk = torch.arange(K, device=det.device)[None, None, :].expand(B, P, K)
    val = det[bb, kk, py, px]

    def at(yy, xx):
        return det[bb, kk, torch.clamp(yy, 0, H - 1), torch.clamp(xx, 0, W - 1)]

    fx = px.float() + 0.5 + torch.where(at(py, px + 1) > at(py, px - 1), 0.25, -0.25)
    fy = py.float() + 0.5 + torch.where(at(py + 1, px) > at(py - 1, px), 0.25, -0.25)
    fill = (val > 0) & (people[..., 2] == 0)
    out = people.clone()
    out[..., 0] = torch.where(fill, fx, people[..., 0])
    out[..., 1] = torch.where(fill, fy, people[..., 1])
    out[..., 2] = torch.where(fill, val, people[..., 2])
    return torch.where(exists[..., None, None], out, 0.0)
