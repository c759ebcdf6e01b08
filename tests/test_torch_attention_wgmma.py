"""K2 at bf16 (``csrc/attention_bf16.cu``): the layouts of its warpgroup MMAs and TMA tiles, emulated
on the CPU with the kernel's own constants.

The kernel copies a 64-row tile of a [B, S, D] bf16 tensor as D / 16 TMA boxes of 16 columns, each
a "slab" of 64 rows x 32 bytes stored with the 32-byte swizzle, and reads the slabs back through
wgmma shared-memory descriptors: K-major (a slab is one 16-deep step of a contraction) for the
operands of S = Q K^T, dP = dO V^T and their transposes, MN-major (16 rows of the tile across its
slabs) for the tiles that the split products P V, P^T dO, dS^T Q and dS K contract down their rows.
Its score accumulators feed those products from registers (acc_to_a). These tests model:

- the TMA's write of a box: row r, column c at r * 32 + 2c from the slab's start, rows outside the
  tensor written as zeros, then the swizzle of the address (bit 4 ^= bit 7);
- the descriptor: its bit fields (start, LBO, SBO in 16-byte units, the layout type) and the
  address of each element of a K-major or MN-major operand under the 32-byte swizzle, with rows
  32 bytes apart inside a group of 8 (the swizzle's span);
- the m64nNk16 accumulator of each thread (warp w, lane 4g + t): d[n][i] at row 16w + g + 8(i // 2),
  column 8n + 2t + i % 2; and the register A operand: a[i] holds row 16w + g + 8(i % 2), columns
  2t + 8(i // 2) and the next;

and show that every product the kernels issue, at every head width, equals the plain product of the
same bf16 values.
"""

import re
from pathlib import Path

import numpy as np
import pytest

SOURCE = Path(__file__).resolve().parents[1] / "neuradar_tpu_torch" / "csrc" / "attention_bf16.cu"
SRC = SOURCE.read_text()
WIDTHS = (16, 32, 48, 64)


def _constants() -> dict:
    """The kernel's integer constants of namespace scope (``constexpr ... kName = expr;``, plain
    arithmetic), evaluated in order."""
    env = {}
    for name, expr in re.findall(r"^constexpr (?:int|uint32_t|uint64_t) (k\w+) = ([^;?]+);", SRC, re.M):
        env[name] = eval(re.sub(r"(\d)u\b", r"\1", expr), {}, dict(env))  # noqa: S307 - the repo's own source
    return env


C = _constants()
SWIZZLE_SPAN = 32  # bytes: the 32-byte swizzle, the descriptor's layout type 3


def test_the_kernel_is_built_on_these_layouts():
    """The emulation below follows these lines of the kernel; a change there must change it too."""
    assert C["kBoxCols"] * 2 == C["kRowBytes"] == SWIZZLE_SPAN and C["kSwizzle32"] == 3
    assert C["kSlabBytes"] == C["kTile"] * C["kRowBytes"] and C["kSbo"] == 8 * C["kRowBytes"]
    assert C["kMnLbo"] == C["kSlabBytes"] and C["kAlign"] % 256 == 0
    assert "CU_TENSOR_MAP_SWIZZLE_32B" in SRC
    assert "const cuuint32_t box[3] = {kBoxCols, kTile, 1};" in SRC
    assert "tma_load_box(dst + j * kSlabBytes, map, bar, j * kBoxCols, row, b)" in SRC
    assert "return smem_desc(tile + kk * kSlabBytes, kKmajorLbo, kSbo);" in SRC
    assert "return smem_desc(tile + kk * 16 * kRowBytes, kMnLbo, kSbo);" in SRC
    # the dQ pass reads lse2 and delta of every row of its grid: the padding covers a block's rows
    assert C["kPad"] % (C["kTile"] * C["kGroups"]) == 0


# ---------------------------------------------------------------------------- shared memory


def swizzle(addr):
    """The 32-byte swizzle of a shared-memory byte address: the 16-byte half flips with bit 7."""
    return addr ^ (((addr >> 7) & 1) << 4)


class Smem:
    """Shared memory as bf16 cells (raw 16-bit patterns held as float64 values)."""

    def __init__(self, nbytes=1 << 17):
        self.cells = np.full(nbytes // 2, np.nan)

    def tma_box(self, dst, x, row0):
        """One box: rows row0 .. row0 + 63 of x [S, 16] (zeros past S) at dst, swizzled."""
        assert dst % 256 == 0
        r, c = np.meshgrid(np.arange(C["kTile"]), np.arange(C["kBoxCols"]), indexing="ij")
        rows = row0 + r
        vals = np.where(rows < x.shape[0], x[np.minimum(rows, x.shape[0] - 1), c], 0.0)
        self.cells[swizzle(dst + r * C["kRowBytes"] + 2 * c) // 2] = vals

    def load_tile(self, dst, x, row0):
        """The kernel's load_tile: D / 16 boxes, box j into slab j."""
        for j in range(x.shape[1] // C["kBoxCols"]):
            self.tma_box(dst + j * C["kSlabBytes"], x[:, 16 * j:16 * j + 16], row0)

    def read(self, addr):
        return self.cells[swizzle(addr) // 2]


def smem_desc(addr, lbo, sbo):
    """The kernel's smem_desc: start, LBO and SBO in 16-byte units, layout type in bits 62-63."""
    return ((addr & 0x3FFFF) >> 4) | (lbo >> 4) << 16 | (sbo >> 4) << 32 | C["kSwizzle32"] << 62


def decode(desc):
    return (desc & 0x3FFF) << 4, ((desc >> 16) & 0x3FFF) << 4, ((desc >> 32) & 0x3FFF) << 4, desc >> 62


def desc_k(tile, kk):
    return smem_desc(tile + kk * C["kSlabBytes"], C["kKmajorLbo"], C["kSbo"])


def desc_mn(tile, kk):
    return smem_desc(tile + kk * 16 * C["kRowBytes"], C["kMnLbo"], C["kSbo"])


def read_kmajor(smem, desc, rows):
    """A K-major operand [rows, 16] through a descriptor: 8-row groups SBO apart, rows 32 bytes
    apart inside a group, the two 8-element halves of a row 16 bytes apart."""
    start, _, sbo, layout = decode(desc)
    assert layout == 3
    r, k = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
    return smem.read(start + (r // 8) * sbo + (r % 8) * SWIZZLE_SPAN + (k // 8) * 16 + (k % 8) * 2)


def read_mnmajor(smem, desc, cols):
    """An MN-major operand [16, cols] through a descriptor: 16-column groups LBO apart, 8-row
    groups SBO apart, rows 32 bytes apart inside a group."""
    start, lbo, sbo, layout = decode(desc)
    assert layout == 3
    k, n = np.meshgrid(np.arange(16), np.arange(cols), indexing="ij")
    return smem.read(start + (n // 16) * lbo + (k // 8) * sbo + (k % 8) * SWIZZLE_SPAN + ((n % 16) // 8) * 16
                     + (n % 8) * 2)


# ---------------------------------------------------------------------------- registers

# the 128 threads of a warpgroup: warp, g = lane // 4, t = lane % 4
WARP, G, T = (a[..., None, None] for a in np.meshgrid(np.arange(4), np.arange(8), np.arange(4), indexing="ij"))


def acc_index(N):
    """Row and column of each thread's accumulator register d[n][i] of m64nNk16."""
    n, i = np.arange(N // 8)[:, None], np.arange(4)[None, :]
    return 16 * WARP + G + 8 * (i // 2), 8 * n + 2 * T + i % 2


def to_acc(m):
    return m[acc_index(m.shape[1])]


def from_acc(acc):
    rows, cols = acc_index(8 * acc.shape[-2])
    out = np.full((64, 8 * acc.shape[-2]), np.nan)
    out[rows, cols] = acc
    return out


def acc_to_a(acc, kk):
    """The kernel's acc_to_a for step kk: registers (c0[0], c0[1]), (c0[2], c0[3]), (c1[0], c1[1]),
    (c1[2], c1[3]) of accumulator groups c0 = 2kk, c1 = 2kk + 1, as [thread..., register, half]."""
    c0, c1 = acc[..., 2 * kk, :], acc[..., 2 * kk + 1, :]
    return np.stack([c0[..., 0:2], c0[..., 2:4], c1[..., 0:2], c1[..., 2:4]], axis=-2)


def from_a(regs):
    """The A operand [64, 16] that the registers hold."""
    i, h = np.arange(4)[:, None], np.arange(2)[None, :]
    out = np.full((64, 16), np.nan)
    out[16 * WARP + G + 8 * (i % 2), 2 * T + 8 * (i // 2) + h] = regs
    return out


def wgmma(acc, a, b, accumulate):
    """m64nNk16 on a warpgroup's registers: d = a b (+ d)."""
    d = to_acc(a @ b)
    return d + acc if accumulate else d


def bf16(x):
    import torch

    return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(torch.bfloat16).double().numpy()


def split(x):
    hi = bf16(x)
    return hi, bf16(x - hi)


# ---------------------------------------------------------------------------- the products


def _tiles(D, S=150, row0=128, seed=0):
    """Two 64-row tiles of [S, D] tensors from row0 (the ragged last tile of S = 150), staged as the
    kernel stages them, and the same tiles in plain form (zero rows past S)."""
    rng = np.random.RandomState(seed + D)
    x, y = (bf16(rng.normal(size=(S, D))) for _ in range(2))
    smem = Smem()
    tx, ty = 1024, 1024 + D // 16 * C["kSlabBytes"]
    smem.load_tile(tx, x, row0)
    smem.load_tile(ty, y, row0)
    plain = [np.zeros((64, D)) for _ in range(2)]
    plain[0][:S - row0], plain[1][:S - row0] = x[row0:], y[row0:]
    return smem, tx, ty, plain


@pytest.mark.parametrize("D", WIDTHS)
def test_tma_tiles_hold_the_rows_and_zeros_past_s(D):
    """A slab's rows read back unswizzled are the tensor's rows, and rows past S are zeros."""
    smem, tx, _, (x, _) = _tiles(D)
    for j in range(D // 16):
        r, c = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
        got = smem.read(tx + j * C["kSlabBytes"] + r * 32 + 2 * c)
        np.testing.assert_array_equal(got, x[:, 16 * j:16 * j + 16])
    assert not x[22:].any()  # S = 150 from row 128: 22 rows


@pytest.mark.parametrize("D", WIDTHS)
def test_score_products_of_k_major_tiles(D):
    """S = Q K^T (forward, dQ pass), S^T = K Q^T and dP^T = V dO^T (dK/dV pass): m64n64k16 with A
    and B through desc_k, D / 16 steps from a fresh accumulator, against the plain product."""
    smem, ta, tb, (a, b) = _tiles(D)
    acc = None
    for kk in range(D // 16):
        am = read_kmajor(smem, desc_k(ta, kk), 64)
        bm = read_kmajor(smem, desc_k(tb, kk), 64)
        acc = wgmma(acc, am, bm.T, accumulate=kk > 0)
    np.testing.assert_array_equal(from_acc(acc), a @ b.T)


@pytest.mark.parametrize("D", WIDTHS)
def test_split_products_of_transposed_tiles(D):
    """O = P V, dV = P^T dO, dK = dS^T Q and dQ = dS K: the score accumulator split into hi and lo
    registers (acc_to_a), B = the tile through desc_mn, lo then hi for each 16 rows of the tile,
    against the plain product of the split parts."""
    smem, _, tb, (_, v) = _tiles(D)
    rng = np.random.RandomState(D)
    p = rng.uniform(0, 1, size=(64, 64)) * rng.uniform(0, 1, size=(64, 1))  # float32 probabilities
    s_acc = to_acc(p)
    part = None
    for kk in range(4):
        regs = acc_to_a(s_acc, kk)
        hi, lo = split(regs)
        bm = read_mnmajor(smem, desc_mn(tb, kk), D)
        part = wgmma(part, from_a(lo), bm, accumulate=kk > 0)
        part = wgmma(part, from_a(hi), bm, accumulate=True)
        np.testing.assert_array_equal(from_a(regs), p[:, 16 * kk:16 * kk + 16])
    hi, lo = split(p)
    want = lo @ v + hi @ v
    np.testing.assert_allclose(from_acc(part), want, rtol=1e-12, atol=1e-12)
    # and the split carries P to about 2^-17 of itself, the point of the two passes
    np.testing.assert_allclose(from_acc(part), p @ v, rtol=0, atol=2.0**-15 * np.abs(v).max() * 64)


def test_descriptor_fields_round_trip():
    """smem_desc's bit fields decode to the address and strides the kernel gave it."""
    for addr in (1024, 1024 + 3 * 2048 + 512, 200 * 1024):
        for lbo, sbo in ((C["kKmajorLbo"], C["kSbo"]), (C["kMnLbo"], C["kSbo"])):
            assert decode(smem_desc(addr, lbo, sbo)) == (addr, lbo, sbo, 3)


def _ladder_variants():
    from neuradar_tpu_torch.scripts import k2_ladder

    return [(source, name) for source, variants in k2_ladder.VARIANTS.items() for name in variants]


@pytest.mark.parametrize("source,name", _ladder_variants())
def test_k2_ladder_variants_patch_the_committed_source(source, name):
    """Each of the ladder's text patches matches its kernel's source exactly once."""
    from neuradar_tpu_torch.scripts import k2_ladder

    text = k2_ladder.variant_source(source, name)
    assert (text == (SOURCE.parent / source).read_text()) == (name == "committed")
