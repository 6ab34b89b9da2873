"""K4: the refine step's penalized argmax and its epilogue against the JAX
package.

On the CPU ``refine_argmax`` runs its plain twin ``refine_argmax_ref``;
``refine_batch`` (need-predicated, one kernel launch) and the unpredicated
per-person twin ``ops.group.refine`` must equal the JAX reference
``jax.vmap(litepose_tpu.ops.group.refine)`` and the Pallas ``refine_batch``
(interpret mode) bit for bit.  The CUDA kernel is held against the twin on
the card (marked ``cuda``, skipped without one).

The machine with the card has no jax: only fixtures import the JAX package,
so ``pytest --noconftest -m cuda`` runs this file there."""

import numpy as np
import pytest
import torch

from litepose_tpu_torch.ops.group import refine
from litepose_tpu_torch.ops.refine import refine_argmax, refine_argmax_ref, refine_batch


@pytest.fixture(scope="module")
def jref():
    """(jax.vmap(group.refine) on "hwt" tags, Pallas refine_batch in
    interpret mode on "thw" tags), both returning numpy."""
    import jax
    import jax.numpy as jnp
    from litepose_tpu.ops.group import refine as j_refine
    from litepose_tpu.ops.pallas_refine import refine_batch as j_refine_batch

    def vmapped(people, det, tag_thw):
        tag_hwt = np.transpose(tag_thw, (0, 1, 3, 4, 2))
        return np.asarray(jax.vmap(j_refine)(jnp.asarray(people), jnp.asarray(det),
                                             jnp.asarray(tag_hwt)))

    def pallas(people, det, tag_thw):
        return np.asarray(j_refine_batch(jnp.asarray(people), jnp.asarray(det),
                                         jnp.asarray(tag_thw), interpret=True,
                                         tag_layout="thw"))

    return vmapped, pallas


def _case(seed, B, P, K, H, W, T, ties=False):
    """people (B,P,K,3+T) with some live persons, det (B,K,H,W), tag
    (B,K,T,H,W); ``ties`` plants equal maxima of det - rint(tt) and tag
    distances on x.5."""
    rng = np.random.default_rng(seed)
    det = rng.standard_normal((B, K, H, W)).astype(np.float32)
    tag = (rng.standard_normal((B, K, T, H, W)) * 2).astype(np.float32)
    people = np.zeros((B, P, K, 3 + T), np.float32)
    for b in range(B):
        for p in range(int(rng.integers(0, P + 1))):
            joints = rng.random(K) < 0.6
            people[b, p, joints, 0] = rng.integers(0, W, joints.sum())
            people[b, p, joints, 1] = rng.integers(0, H, joints.sum())
            people[b, p, joints, 2] = rng.random(joints.sum()) + 0.1
            people[b, p, joints, 3:] = rng.standard_normal((joints.sum(), T))
    if ties:
        people[0, 0] = 0.0  # person 0: one joint at (0, 0), tag mean 0
        people[0, 0, 0, :3] = [0.0, 0.0, 1.0]
        tag[0] = 0.0
        tag[0, :, 0, 1, :] = 0.5  # |tt| = 0.5 -> rint 0 (half to even)
        tag[0, :, 0, 2, :] = 1.5  # -> 2
        tag[0, :, 0, 3, :] = 2.5  # -> 2
        det[0] = 0.25
        det[0, :, 1, 3] = det[0, :, 3, 1] = 1.25  # tied maxima
    return people, det, tag


@pytest.mark.parametrize("T", [1, 2, 3, 4])
@pytest.mark.parametrize("ties", [False, True])
def test_refine_matches_jax(jref, T, ties):
    vmapped, pallas = jref
    people, det, tag = _case(T + 2 * ties, B=3, P=6, K=5, H=12, W=20, T=T, ties=ties)
    want = vmapped(people, det, tag)
    np.testing.assert_array_equal(pallas(people, det, tag), want)
    args = (torch.from_numpy(people), torch.from_numpy(det), torch.from_numpy(tag))
    np.testing.assert_array_equal(refine_batch(*args, tag_layout="thw").numpy(), want)
    np.testing.assert_array_equal(refine(*args).numpy(), want)


def test_refine_empty_people(jref):
    vmapped, _ = jref
    _, det, tag = _case(4, B=2, P=4, K=3, H=10, W=10, T=1)
    people = np.zeros((2, 4, 3, 4), np.float32)
    got = refine_batch(torch.from_numpy(people), torch.from_numpy(det), torch.from_numpy(tag),
                       tag_layout="thw")
    np.testing.assert_array_equal(got.numpy(), vmapped(people, det, tag))
    assert not got.numpy().any()


def test_refine_argmax_twin_matches_pallas_argmax():
    """The twin against the Pallas argmax itself: all-zero, sparse and full
    ``need``, ties to the lowest flat index."""
    import jax.numpy as jnp
    from litepose_tpu.ops.pallas_refine import refine_argmax_pallas

    rng = np.random.default_rng(9)
    B, K, P, H, W, T = 2, 3, 5, 8, 11, 2
    det = rng.integers(0, 3, (B, K, H, W)).astype(np.float32)  # many ties
    tag = rng.integers(-2, 3, (B, K, T, H, W)).astype(np.float32) * 0.5
    prev = rng.integers(-2, 3, (B, P, T)).astype(np.float32) * 0.5
    need = (rng.random((B, K, P)) < 0.5).astype(np.int32)
    need[0] = 0
    need[1] = 1
    want = np.asarray(refine_argmax_pallas(jnp.asarray(need), jnp.asarray(prev),
                                           jnp.asarray(det), jnp.asarray(tag), interpret=True))
    got = refine_argmax_ref(*(torch.from_numpy(a) for a in (need, prev, det, tag)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[0].any()


def test_round_is_half_to_even():
    """rint(tt) in the penalty rounds half to even, as jnp.round and the
    kernel's rintf do."""
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 3.5000002])
    assert torch.round(x).tolist() == [0.0, 2.0, 2.0, -0.0, -2.0, 4.0]
    # a plane where only half-to-even picks pixel 1: tt = 2.5 there (rint 2)
    # and 1.5 at pixel 0 (rint 2), det higher at pixel 1
    det = torch.tensor([[[[0.0, 0.5, 0.0]]]])
    tag = torch.tensor([[[[[1.5, 2.5, 4.0]]]]])
    pos = refine_argmax(torch.ones((1, 1, 1), dtype=torch.int32),
                        torch.zeros((1, 1, 1)), det, tag)
    assert pos.item() == 1


# -- the tiled kernel's reduction, emulated in torch -------------------------


def penalty_keys(penal: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel's 64-bit key (orderable_u32(penal) << 32) | (0xFFFFFFFF -
    idx), -0.0 taken as +0.0, as int64 with the top bit flipped (int64 order
    = the key's unsigned order)."""
    bits = penal.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    bits = torch.where(bits == 0x80000000, 0, bits)
    ord_ = torch.where(bits >= 0x80000000, ~bits & 0xFFFFFFFF, bits | 0x80000000)
    return ((ord_ - 2**31) << 32) | (0xFFFFFFFF - idx.long())


def tiled_refine_argmax(need, prev, det, tag, threads=256, vec=4, loads=4):
    """K4 as the kernel reduces it: tiles of threads * vec * loads pixels;
    a thread walks its pixels (16-byte load l holds pixels base + (l *
    threads + t) * vec + [0, vec)) in increasing index order keeping the
    first strict float maximum; its key; the tile's largest key (the warp
    shuffle and the CTA's reduction); the largest over tiles (atomicMax);
    pos = 0xFFFFFFFF - low 32 bits where needed, else 0."""
    from litepose_tpu_torch.ops.refine import _tag_distance

    B, K, H, W = det.shape
    P, HW = need.shape[2], H * W
    tile = threads * vec * loads
    n_tiles = -(-HW // tile)
    e = torch.arange(vec * loads)
    t = torch.arange(threads)
    # (tiles, threads, elements) flat indices, in each thread's walk order
    idx = (torch.arange(n_tiles)[:, None, None] * tile
           + ((e // vec)[None, None, :] * threads + t[None, :, None]) * vec
           + (e % vec)[None, None, :])
    valid = idx < HW
    pos = torch.zeros((B, K, P), dtype=torch.int32)
    for b, k, p in need.nonzero().tolist():
        penal = (det[b, k] - torch.round(_tag_distance(tag[b, k][None],
                                                       prev[b, p][None])[0])).flatten()
        pv = penal[idx.clamp(max=HW - 1)]
        best_v, best_i = pv[..., 0], idx[..., 0]
        for j in range(1, vec * loads):
            better = valid[..., j] & (pv[..., j] > best_v)
            best_v = torch.where(better, pv[..., j], best_v)
            best_i = torch.where(better, idx[..., j], best_i)
        keys = torch.where(valid[..., 0], penalty_keys(best_v, best_i),
                           torch.iinfo(torch.int64).min)
        winner = keys.amax(1).amax(0)
        pos[b, k, p] = int(0xFFFFFFFF - (winner & 0xFFFFFFFF))
    return pos


def _refine_inputs(seed, T, need_kind, H=12, W=21, B=2, K=3, P=6, signed_zeros=False):
    rng = np.random.default_rng(seed)
    det = rng.integers(0, 4, (B, K, H, W)).astype(np.float32) * 0.25  # ties
    tag = rng.integers(-6, 7, (B, K, T, H, W)).astype(np.float32) * 0.25  # x.5
    prev = rng.integers(-4, 5, (B, P, T)).astype(np.float32) * 0.25
    p_need = {"none": 0.0, "sparse": 0.3, "full": 1.0}[need_kind]
    need = (rng.random((B, K, P)) < p_need).astype(np.int32)
    if signed_zeros:
        # every penalty at most 0; the maxima are -0.0 (det -0.0, rint(tt) 0)
        # before +0.0 in flat order, which a raw float key would rank lower
        det[:] = -1.0
        det[..., 2, 3:] = -0.0
        det[..., 5, :] = 0.0
        tag[:] = prev[0, 0][None, None, :, None, None]
        prev[:] = prev[0, 0]
    return [torch.from_numpy(a) for a in (need, prev, det, tag)]


@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("need_kind", ["none", "sparse", "full"])
@pytest.mark.parametrize("geometry", [(256, 4, 4), (4, 2, 2), (8, 4, 1)])
def test_tiled_emulation_matches_twin(T, need_kind, geometry):
    """The kernel's tile size and small ones (many tiles, a partial last
    tile), planted ties and tag distances on x.5: equal to the twin."""
    threads, vec, loads = geometry
    args = _refine_inputs(T, T, need_kind)
    want = refine_argmax_ref(*args)
    assert torch.equal(tiled_refine_argmax(*args, threads, vec, loads), want)


@pytest.mark.parametrize("T", [1, 2])
def test_tiled_emulation_signed_zeros(T):
    """-0.0 and +0.0 maxima: the twin's float compare ties them, so the
    lowest index wins; the key must map -0.0 to +0.0 to agree."""
    args = _refine_inputs(5, T, "full", signed_zeros=True)
    want = refine_argmax_ref(*args)
    assert (want == 2 * 21 + 3).all()  # the first -0.0, before the +0.0 row
    assert torch.equal(tiled_refine_argmax(*args, 4, 2, 2), want)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K4 kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2, 3, 4])
@pytest.mark.parametrize("need_kind", ["none", "sparse", "full"])
@pytest.mark.parametrize("hw", [(12, 20), (448, 576)])
def test_kernel_matches_twin_on_card(cuda, T, need_kind, hw):
    rng = np.random.default_rng(T)
    B, K, P = 2, 14, 40
    H, W = hw
    det = rng.integers(0, 4, (B, K, H, W)).astype(np.float32) * 0.25  # ties
    tag = rng.integers(-6, 7, (B, K, T, H, W)).astype(np.float32) * 0.25  # x.5
    prev = rng.integers(-4, 5, (B, P, T)).astype(np.float32) * 0.25
    p_need = {"none": 0.0, "sparse": 0.1, "full": 1.0}[need_kind]
    need = (rng.random((B, K, P)) < p_need).astype(np.int32)
    args = [torch.from_numpy(a) for a in (need, prev, det, tag)]
    want = refine_argmax_ref(*args)
    before = refine_argmax.launches
    got = refine_argmax(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert refine_argmax.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2, 3, 4])
@pytest.mark.parametrize("hw", [(12, 21), (448, 448), (45, 103)])
def test_kernel_signed_zeros_and_mixed_need_on_card(cuda, T, hw):
    """-0.0 maxima before +0.0 ones; one plane with all 40 slots needed
    beside planes with none; sizes that leave a partial tile and that rule
    out 16-byte loads."""
    args = _refine_inputs(7, T, "none", H=hw[0], W=hw[1], B=2, K=14, P=40,
                          signed_zeros=True)
    args[0][1, 3] = 1  # all 40 slots of one plane, the other 27 planes none
    want = refine_argmax_ref(*args)
    got = refine_argmax(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert (want[1, 3] == 2 * hw[1] + 3).all()
