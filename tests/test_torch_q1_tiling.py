"""A plain model of Q1's tile walk (``csrc/quant_conv.cu``) and of its
quantization arithmetic, on the CPU.

The CUDA kernel cannot run here, so its indexing and its division are
held in Python:

- the walk: output tiles of ``tile_shape(co)`` pixels per block of
  ``co_tile(co)`` output channels; per chunk of 32 input channels the halo
  tile staged as two planes of 16 channels x halo pixels x 16 bytes (zeros
  outside the map and past Ci); each of the block's four units' A operand
  (an 8x8 patch, 64 x 32 int8) read through the no-swizzle K-major
  descriptor, a tap being a shift of its start address; B from the packed
  weights through its descriptor (N = 64 a unit, 8 for Co <= 8); the wgmma
  fragment's rows and columns mapped back to pixels and channels as the
  epilogue stores them. It must give the exact int32 conv of ``quant_conv3_plain``, ragged
  H, W, Ci and Co included;
- ``pack_weights`` / ``unpack_weights`` round trips and the packed layout;
- the quantization without a division per element (``quant1``): an
  IEEE-rounded reciprocal, two FMA corrections, the clamp and the 1.5 * 2^23
  rounding, replayed in exact rational arithmetic against numpy's IEEE
  float32 division at and next to the rounding ties, at the clamp and past
  it.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from fastdiffsr_tpu_torch.ops import quant

torch.set_num_threads(1)

KC = quant.K_STEP          # input channels per chunk (one k32)
PLANE_CH = 16              # channels of an int8 plane (one core matrix row)
UNITS = 4                  # (8x8 patch, N range) units of a block


def wn(co):
    """Output channels of one unit's wgmma."""
    return 8 if co <= 8 else 64


def stage_chunk(q_h, b, y0, x0, c0, th, tw):
    """The staged A buffer of one chunk, as bytes: plane-major, then halo
    pixel, then 16 channels; zeros outside the map and past Ci."""
    B, H, W, ci = q_h.shape
    hh, hw = th + 2, tw + 2
    buf = torch.zeros(2 * hh * hw * PLANE_CH, dtype=torch.int64)
    for px in range(hh * hw):
        gy, gx = y0 - 1 + px // hw, x0 - 1 + px % hw
        if not (0 <= gy < H and 0 <= gx < W):
            continue
        for plane in range(2):
            for k in range(PLANE_CH):
                c = c0 + plane * PLANE_CH + k
                if c < ci:
                    buf[(plane * hh * hw + px) * PLANE_CH + k] = q_h[b, gy, gx,
                                                                    c]
    return buf


def core_matrix_index(start, lbo, sbo, rows):
    """Byte addresses of a (rows x 32) K-major no-swizzle operand: element
    (r, k) of 8-row group r // 8 at start + (r // 8) sbo + (r % 8) 16 +
    (k // 16) lbo + k % 16."""
    r = torch.arange(rows)[:, None]
    k = torch.arange(KC)[None, :]
    return start + (r // 8) * sbo + (r % 8) * 16 + (k // 16) * lbo + k % 16


def walk(q_h, packed, co):
    """Q1's int32 output of an int8 map and packed weights, computed the
    way the kernel's blocks, chunks, taps and fragments walk it."""
    B, H, W, ci = q_h.shape
    g_n, n_chunks, _, _, bn, _ = packed.shape
    th, tw = quant.tile_shape(co)
    n_wn = wn(co)
    ns = bn // n_wn                        # units sharing a patch
    patches = UNITS // ns
    hw = tw + 2
    qb = (th + 2) * hw * PLANE_CH          # bytes of one plane
    flat_w = packed.reshape(g_n, n_chunks, -1).long()
    out = torch.zeros((B, H, W, co), dtype=torch.int64)
    tiles = [(b, y0, x0) for b in range(B) for y0 in range(0, H, th)
             for x0 in range(0, W, tw)]
    for cog in range(g_n):
        for b, y0, x0 in tiles:
            acc = torch.zeros((UNITS, 64, n_wn), dtype=torch.int64)
            for chunk in range(n_chunks):
                a_buf = stage_chunk(q_h, b, y0, x0, chunk * KC, th, tw)
                b_buf = flat_w[cog, chunk]
                for u in range(UNITS):
                    patch, nh = u % patches, u // patches
                    py0, px0 = (patch // (tw // 8)) * 8, (patch % (tw // 8)) * 8
                    for t in range(9):
                        a_idx = core_matrix_index(
                            ((py0 + t // 3) * hw + px0 + t % 3) * 16, qb,
                            hw * 16, 64)
                        b_idx = core_matrix_index(
                            t * 2 * bn * 16 + nh * n_wn * 16, bn * 16, 128,
                            n_wn)
                        acc[u] += a_buf[a_idx] @ b_buf[b_idx].T
            # the fragment: element 4j + 2p + e of lane l in warp w (of
            # the unit's warpgroup) is row 16 w + l // 4 + 8 p, channel 8 j
            # + 2 (l % 4) + e; a row is patch pixel (row // 8, row % 8)
            for u in range(UNITS):
                patch, nh = u % patches, u // patches
                py0, px0 = (patch // (tw // 8)) * 8, (patch % (tw // 8)) * 8
                for w in range(4):
                    for lane in range(32):
                        for p in range(2):
                            oy = y0 + py0 + 2 * w + p
                            ox = x0 + px0 + lane // 4
                            row = 16 * w + lane // 4 + 8 * p
                            assert (row // 8, row % 8) == (2 * w + p,
                                                           lane // 4)
                            for j in range(n_wn // 8):
                                for e in range(2):
                                    c = (cog * bn + nh * n_wn + 8 * j
                                         + 2 * (lane % 4) + e)
                                    if oy < H and ox < W and c < co:
                                        out[b, oy, ox, c] = acc[
                                            u, row, 8 * j + 2 * (lane % 4)
                                            + e]
    return out


# (B, H, W, Ci, Co): the final Block's N = 8 with ragged H, W; Ci = 4,
# 36 and 100 (padded chunks); Co = 64 (16x16 tiles), 80 (8x16, two units
# a patch, a partial N), 200 (8x8, four a patch) and 300 (a second block
# of output channels)
WALK_CASES = [(1, 11, 13, 36, 3), (2, 9, 18, 4, 64), (1, 17, 10, 100, 80),
              (1, 9, 9, 40, 200), (1, 8, 10, 8, 300)]


@pytest.mark.parametrize("case", WALK_CASES)
def test_tile_walk_is_the_exact_int32_conv(case):
    B, H, W, ci, co = case
    rng = np.random.default_rng(sum(case))
    q_h = torch.from_numpy(rng.integers(-127, 128, (B, H, W, ci),
                                        dtype=np.int8))
    q_w = torch.from_numpy(rng.integers(-127, 128, (co, ci, 3, 3),
                                        dtype=np.int8))
    packed = quant.pack_weights(q_w)
    want = quant.quant_conv3_plain(q_h, q_w)
    assert torch.equal(walk(q_h, packed, co), want.long())


@pytest.mark.parametrize("co", [1, 3, 8, 9, 64, 65, 128, 129, 256, 257, 512])
def test_tiles_cover_all_of_co_in_one_block(co):
    """One block row holds all output channels up to 256; the tile is four,
    two or one 8x8 patches as 1, 2 or 4 n64 units share each."""
    bn = quant.co_tile(co)
    assert bn == (8 if co <= 8 else 64 if co <= 64 else 128 if co <= 128
                  else 256)
    assert bn >= min(co, 256)
    th, tw = quant.tile_shape(co)
    assert (th // 8) * (tw // 8) * (bn // wn(co)) == UNITS or bn == 8
    assert quant.packed_shape(co, 40)[0] == -(-co // bn)


@pytest.mark.parametrize("co,ci", [(3, 4), (24, 64), (80, 36), (256, 100),
                                   (300, 192)])
def test_pack_weights_round_trip_and_layout(co, ci):
    rng = np.random.default_rng(co + ci)
    q_w = torch.from_numpy(rng.integers(-127, 128, (co, ci, 3, 3),
                                        dtype=np.int8))
    packed = quant.pack_weights(q_w)
    g, nk, taps, halves, bn, c16 = packed.shape
    assert packed.shape == quant.packed_shape(co, ci)
    assert (taps, halves, c16) == (9, 2, 16) and packed.is_contiguous()
    assert torch.equal(quant.unpack_weights(packed, co, ci), q_w)
    # element (block, chunk, tap, k-half, n, k) is W[block * bn + n,
    # 32 chunk + 16 half + k, tap // 3, tap % 3], zero in the padding
    full = torch.zeros((g * bn, nk * KC, 3, 3), dtype=torch.int8)
    full[:co, :ci] = q_w
    for _ in range(50):
        i = [int(rng.integers(0, d)) for d in packed.shape]
        blk, chunk, tap, half, n, k = i
        assert packed[tuple(i)] == full[blk * bn + n, chunk * KC + half * 16
                                        + k, tap // 3, tap % 3]


def rn32(x: Fraction) -> np.float32:
    """x rounded to the nearest float32, ties to even."""
    f = np.float32(float(x))
    cands = [f, np.nextafter(f, np.float32(np.inf)),
             np.nextafter(f, np.float32(-np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.array(c).view(np.uint32)) & 1))


def fma(a, b, c) -> np.float32:
    return rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def quant1(v, s):
    """The kernel's quant1 step by step: (the quotient before the clamp,
    the int8 it stores)."""
    r = rn32(1 / Fraction(float(s)))                  # __frcp_rn, per block
    lim = np.float32(128) * s                         # exact
    v = min(max(v, -lim), lim)
    q = rn32(Fraction(float(v)) * Fraction(float(r)))     # __fmul_rn
    q = fma(r, fma(-s, q, v), q)
    q = fma(r, fma(-s, q, v), q)
    quotient = q
    q = min(max(q, np.float32(-127)), np.float32(127))
    bits = (np.float32(q) + np.float32(12582912.0)).view(np.uint32)
    return quotient, np.int8(np.uint8(int(bits) & 0xFF).view(np.int8))


SCALES = [np.float32(8.0 / 127.0), np.float32(1e-12), np.float32(3.0e-3),
          np.float32(0.0312), np.float32(1.7), np.float32(41.3)]


@pytest.mark.parametrize("s", SCALES)
def test_quant1_matches_ieee_division_at_the_ties(s):
    """At (k + 1/2) s_a and its neighbours (4 ulps each way) for every k
    in [-128, 127], at +-127.5 s_a and +-128 s_a and past them, and at
    random values: the quotient equals numpy's IEEE float32 v / s_a below
    the clamp, and the stored int8 is clamp(rint(v / s_a), -127, 127)."""
    rng = np.random.default_rng(int(s.view(np.uint32)))
    vals = []
    for k in range(-128, 128):
        v = np.float32((k + 0.5) * float(s))
        for _ in range(4):
            v = np.nextafter(v, np.float32(-np.inf))
        for _ in range(9):
            vals.append(v)
            v = np.nextafter(v, np.float32(np.inf))
    for m in (127.5, 128.0, 300.0, 1e30):
        vals += [np.float32(m * float(s)), np.float32(-m * float(s))]
    vals += list((rng.standard_normal(200) * 60 * float(s)).astype(
        np.float32))
    vals += [np.float32(0.0), np.float32(-0.0), np.float32(3e38)]
    for v in vals:
        with np.errstate(over="ignore"):
            want_q = np.float32(v) / s
        quotient, got = quant1(v, s)
        if abs(float(want_q)) < 128:
            assert quotient == want_q, (v, s)
        want = np.int8(np.clip(np.rint(want_q), -127, 127))
        assert got == want, (v, s, want_q)
