"""K2 at bfloat16: the numerics of ``csrc/attention_bf16.cu``, emulated on the CPU, and the kernels
on the card.

The kernel runs every S*S*D product as ``mma.sync.m16n8k16`` with bf16 operands and float32
accumulation. Where both operands are bf16 (S = Q K^T, dP = dO V^T) that is one product, exact in
its float32 sum up to summation order. Where one operand is float32 (P, dS) it is split into
hi = bf16(x) and lo = bf16(x - hi) and multiplied in two passes. The backward's delta =
rowsum(dO o O) is taken from the output in float32, as the forward writes it when it will be
differentiated. These tests emulate:

- the m16n8k16 fragment layouts of the PTX ISA (A: rows g, g + 8 x columns 2t, 2t + 1, 2t + 8,
  2t + 9; B: rows 2t, 2t + 1, 2t + 8, 2t + 9 of column g; the accumulator rows g, g + 8 x columns
  2t, 2t + 1), with the index expressions of the kernel's load_a, load_b_rows, load_b_cols and
  acc_to_a, against plain products;
- the forward with the hi/lo split and with P rounded once, and the backward with delta from the
  float32 and from the bf16 output, against float64 on the same bf16 inputs.

The split keeps the error far under the bf16 rounding of the outputs; one pass of P does not, and
delta from the bf16 output puts errors of the order of that rounding into dQ and dK. The tests
marked ``cuda`` hold the kernels against the plain version on the card and skip without one:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_attention_bf16.py
"""

import numpy as np
import pytest
import torch

from neuradar_tpu_torch.ops import attention as t_attention

LOG2E = 1.4426950408889634
SEED = 3
# bf16 keeps 8 significant bits: one unit in the last place is 2^-7 of a value in [1, 2)
BF16_ULP = 2.0**-7
# The card against the plain version, both rounding one float32 result to bf16: the float32 results
# differ by summation order (and, in the kernel, by the split's 2^-17), so the two bf16 values are
# equal or one unit apart: rtol one unit, and atol for entries near 0, where float32 noise of the
# row's sums (about 2^-16 of the tensor's largest entry, see test_split_within_bf16_rounding) can
# cross a rounding point of a tiny value.
K2_BF16_TOL = dict(rtol=BF16_ULP, atol=2.0**-12)
K2_BF16_BWD_TOL = dict(rtol=BF16_ULP, atol=2.0**-10)
# the forward's float32 output (before its rounding) against the plain version's float32 result:
# both differ from float64 by float32 sums and, in the kernel, the split (~2e-6 at most here)
K2_OUT32_TOL = dict(rtol=1e-4, atol=2e-5)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest, ties to even) and back to float32."""
    return x.to(torch.bfloat16).float()


def split(x: torch.Tensor):
    hi = bf16(x)
    return hi, bf16(x - hi)


# ---------------------------------------------------------------------------- fragment layouts


def lane(g, t):
    return 4 * g + t


def mma_m16n8k16(a, b, c):
    """One warp's mma.sync.m16n8k16: a [32][4][2], b [32][2][2], c [32][4] per lane, by the PTX
    ISA's layouts; returns d [32][4]."""
    A = torch.zeros(16, 16, dtype=torch.float64)
    B = torch.zeros(16, 8, dtype=torch.float64)
    C = torch.zeros(16, 8, dtype=torch.float64)
    for g in range(8):
        for t in range(4):
            ln = lane(g, t)
            for i in range(8):  # a0..a7: register i // 2, half i % 2
                row = g + 8 * ((i // 2) % 2)
                col = 2 * t + (i % 2) + 8 * (i // 4)
                A[row, col] = a[ln][i // 2][i % 2]
            for i in range(4):  # b0..b3
                B[2 * t + (i % 2) + 8 * (i // 2), g] = b[ln][i // 2][i % 2]
            for i in range(4):  # c0..c3
                C[g + 8 * (i // 2), 2 * t + (i % 2)] = c[ln][i]
    Dm = A @ B + C
    return [[float(Dm[g + 8 * (i // 2), 2 * t + (i % 2)]) for i in range(4)] for g in range(8) for t in range(4)]


def acc_matrix(acc):
    """[kCols][32][4] accumulators of a 16 x 8*kCols tile -> the matrix."""
    out = torch.zeros(16, 8 * len(acc), dtype=torch.float64)
    for n, c in enumerate(acc):
        for g in range(8):
            for t in range(4):
                for i in range(4):
                    out[g + 8 * (i // 2), 8 * n + 2 * t + (i % 2)] = c[lane(g, t)][i]
    return out


# the kernel's loads, index for index (tile[r][c] of a [rows, pitch] tile)
def load_a(tile, r0, c0):
    regs = []
    for g in range(8):
        for t in range(4):
            p = (r0 + g, c0 + 2 * t)
            rows = (p[0], p[0] + 8, p[0], p[0] + 8)
            cols = (p[1], p[1], p[1] + 8, p[1] + 8)
            regs.append([[float(tile[r, c]), float(tile[r, c + 1])] for r, c in zip(rows, cols)])
    return regs


def load_b_rows(tile, n0, k0):
    regs = []
    for g in range(8):
        for t in range(4):
            r, c = n0 + g, k0 + 2 * t
            regs.append([[float(tile[r, c]), float(tile[r, c + 1])], [float(tile[r, c + 8]), float(tile[r, c + 9])]])
    return regs


def load_b_cols(tile, k0, n0):
    regs = []
    for g in range(8):
        for t in range(4):
            r, c = k0 + 2 * t, n0 + g
            regs.append([[float(tile[r, c]), float(tile[r + 1, c])], [float(tile[r + 8, c]), float(tile[r + 9, c])]])
    return regs


def acc_to_a(c0, c1):
    """Two accumulator groups as an A fragment: (g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..)."""
    return [[[c0[ln][0], c0[ln][1]], [c0[ln][2], c0[ln][3]], [c1[ln][0], c1[ln][1]], [c1[ln][2], c1[ln][3]]]
            for ln in range(32)]


def _zero_acc(n):
    return [[[0.0] * 4 for _ in range(32)] for _ in range(n)]


@pytest.mark.parametrize("D", [16, 48])
def test_fragment_layouts_compute_the_products(D):
    """One warp's 16 rows of S = Q K^T (load_a-style Q, load_b_rows K) and of O = P V (acc_to_a of
    the score accumulators, load_b_cols V) equal the plain products on bf16 values."""
    rng = np.random.RandomState(0)
    q = bf16(torch.from_numpy(rng.normal(size=(64, D)).astype(np.float32))).double()
    k = bf16(torch.from_numpy(rng.normal(size=(64, D)).astype(np.float32))).double()
    v = bf16(torch.from_numpy(rng.normal(size=(64, D)).astype(np.float32))).double()
    w0 = 16  # the second warp's rows
    s = _zero_acc(8)
    for c in range(D // 16):
        qa = load_a(q, w0, 16 * c)
        for n in range(8):
            s[n] = mma_m16n8k16(qa, load_b_rows(k, 8 * n, 16 * c), s[n])
    torch.testing.assert_close(acc_matrix(s), q[w0:w0 + 16] @ k.T, rtol=0, atol=1e-12)
    # P V with P = the score accumulators themselves (bf16-valued here, so no split is needed)
    s = [[[float(bf16(torch.tensor(x))) for x in lane_vals] for lane_vals in acc] for acc in s]
    pmat = acc_matrix(s)
    o = _zero_acc(D // 8)
    for j in range(4):
        pa = acc_to_a(s[2 * j], s[2 * j + 1])
        for c in range(D // 8):
            o[c] = mma_m16n8k16(pa, load_b_cols(v, 16 * j, 8 * c), o[c])
    torch.testing.assert_close(acc_matrix(o), pmat @ v, rtol=0, atol=1e-9)


def test_transposed_products_use_the_same_fragments():
    """dK's S^T = K Q^T (load_a K, load_b_rows Q) and dK += dS^T Q (acc_to_a, load_b_cols Q)."""
    rng = np.random.RandomState(1)
    D = 32
    q = bf16(torch.from_numpy(rng.normal(size=(64, D)).astype(np.float32))).double()
    k = bf16(torch.from_numpy(rng.normal(size=(64, D)).astype(np.float32))).double()
    st = _zero_acc(8)
    for c in range(D // 16):
        ka = load_a(k, 48, 16 * c)
        for n in range(8):
            st[n] = mma_m16n8k16(ka, load_b_rows(q, 8 * n, 16 * c), st[n])
    torch.testing.assert_close(acc_matrix(st), k[48:64] @ q.T, rtol=0, atol=1e-12)
    ds = [[[float(bf16(torch.tensor(x * 0.01))) for x in lane_vals] for lane_vals in acc] for acc in st]
    dk = _zero_acc(D // 8)
    for j in range(4):
        dsa = acc_to_a(ds[2 * j], ds[2 * j + 1])
        for c in range(D // 8):
            dk[c] = mma_m16n8k16(dsa, load_b_cols(q, 16 * j, 8 * c), dk[c])
    torch.testing.assert_close(acc_matrix(dk), acc_matrix(ds) @ q, rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------- numerics


def _inputs(B=2, S=300, D=48, seed=1):
    rng = np.random.RandomState(seed)
    return tuple(bf16(torch.from_numpy(rng.normal(size=(B, S, D)).astype(np.float32))) for _ in range(4))


def _matmul_split(x, y):
    hi, lo = split(x)
    return lo @ y + hi @ y


def _matmul_single(x, y):
    return bf16(x) @ y


def forward_emulated(q, k, v, matmul, rate):
    """K2 forward as the bf16 kernel computes it, in float32 on bf16 values: the scores one bf16
    product scaled after it, the float32 softmax, P's product by ``matmul``. Returns the float32
    output (before its rounding), P, and the normaliser."""
    D = q.shape[-1]
    s = (q @ k.transpose(1, 2)) * np.float32(D**-0.5 * LOG2E)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    if rate > 0.0:
        p = p * t_attention.keep_mask(SEED, q.shape[0], q.shape[1], rate) * np.float32(1.0 / (1.0 - rate))
    return matmul(p, v) / l


def backward_emulated(q, k, v, dout, out32, matmul, rate):
    """K2 backward as the bf16 kernel computes it: P from the float32 scores, dP one bf16 product,
    delta = rowsum(dO o out32), dS's and P's products by ``matmul``; (dq, dk, dv) in float32."""
    D = q.shape[-1]
    scale = np.float32(D**-0.5)
    s = (q @ k.transpose(1, 2)) * scale
    p = torch.softmax(s, dim=-1)
    m = torch.ones_like(p)
    if rate > 0.0:
        m = t_attention.keep_mask(SEED, q.shape[0], q.shape[1], rate) * np.float32(1.0 / (1.0 - rate))
    dp = dout @ v.transpose(1, 2)
    delta = (dout * out32).sum(-1, keepdim=True)
    ds = p * (m * dp - delta)
    dv = matmul((m * p).transpose(1, 2), dout)
    dk = scale * matmul(ds.transpose(1, 2), q)
    dq = scale * matmul(ds, k)
    return dq, dk, dv


def _reference64(q, k, v, dout, rate):
    q64, k64, v64 = (x.double().requires_grad_(True) for x in (q, k, v))
    out = t_attention.attention_reference(q64, k64, v64, SEED, rate)
    grads = torch.autograd.grad(out, (q64, k64, v64), dout.double())
    return out.detach(), grads


def _rounding(x64):
    """The largest error of rounding x to bf16."""
    return float((bf16(x64.float()).double() - x64).abs().max())


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_split_within_bf16_rounding_single_pass_not(rate):
    """The forward: with P split, the float32 output is within 1/64 of the output's bf16 rounding
    of float64 (measured: 0.0008-0.0016 of it); with P rounded once it is not (0.46-0.77)."""
    q, k, v, dout = _inputs()
    want, _ = _reference64(q, k, v, dout, rate)
    rounding = _rounding(want)
    err_split = float((forward_emulated(q, k, v, _matmul_split, rate).double() - want).abs().max())
    err_single = float((forward_emulated(q, k, v, _matmul_single, rate).double() - want).abs().max())
    assert err_split < rounding / 64, (err_split, rounding)
    assert err_single > rounding / 4, (err_single, rounding)
    # the tolerances of the card tests: the float32 noise is far under their atol
    assert err_split < K2_BF16_TOL["atol"] / 8 and err_split < K2_OUT32_TOL["atol"] / 8


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_delta_from_the_float32_output(rate):
    """The backward with the split: delta from the forward's float32 output keeps dQ, dK and dV
    within 1/64 of their bf16 rounding (measured: 0.0009-0.0018 of it); delta from the bf16 output
    puts 0.18-0.22 of that rounding into dQ (0.11 into dK), and P rounded once 0.61 into dV."""
    q, k, v, dout = _inputs()
    out64, grads64 = _reference64(q, k, v, dout, rate)
    out32 = forward_emulated(q, k, v, _matmul_split, rate)
    variants = {
        "out32": backward_emulated(q, k, v, dout, out32, _matmul_split, rate),
        "out_bf16": backward_emulated(q, k, v, dout, bf16(out32), _matmul_split, rate),
        "single": backward_emulated(q, k, v, dout, out32, _matmul_single, rate),
    }
    errs = {name: [float((g.double() - w).abs().max()) for g, w in zip(got, grads64)] for name, got in variants.items()}
    roundings = [_rounding(w) for w in grads64]
    for name, e, r in zip(("dq", "dk", "dv"), errs["out32"], roundings):
        assert e < r / 64, (name, e, r)
        assert e < K2_BF16_BWD_TOL["atol"] / 8, (name, e)
    assert errs["out_bf16"][0] > roundings[0] / 16, (errs["out_bf16"], roundings)  # dQ
    assert errs["single"][2] > roundings[2] / 4, (errs["single"], roundings)  # dV


def test_plain_version_rounds_once_at_the_end():
    """The plain version computes in float32 on the bf16 values and returns bf16: its output is the
    float64 output rounded to bf16, to within one unit."""
    q, k, v, dout = _inputs(seed=2)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    got = t_attention.self_attention_fwd(qb, kb, vb, 0.1, SEED)
    assert got.dtype == torch.bfloat16
    want, grads = _reference64(q, k, v, dout, 0.1)
    torch.testing.assert_close(got.double(), want, **K2_BF16_TOL)
    out, lse, out32 = t_attention.self_attention_fwd(qb, kb, vb, 0.1, SEED, return_lse=True, return_out32=True)
    assert lse.dtype == out32.dtype == torch.float32 and torch.equal(out32.to(torch.bfloat16), out)
    for g, w in zip(t_attention.self_attention_bwd(qb, kb, vb, out32, dout.to(torch.bfloat16), lse, 0.1, SEED),
                    grads):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.double(), w, **K2_BF16_BWD_TOL)


def test_batch_offset_seed_shifts_the_mask():
    """The mask of scans b0.. under batch_offset_seed(seed, b0) is the whole batch's mask from b0 on."""
    whole = t_attention.keep_mask(SEED, 6, 40, 0.3)
    part = t_attention.keep_mask(t_attention.batch_offset_seed(SEED, 4), 2, 40, 0.3)
    assert torch.equal(part, whole[4:])


# ---------------------------------------------------------------------------- on the card

K2_LENGTHS = (1, 5, 63, 64, 65, 127, 300, 3531)
K2_WIDTHS = (16, 32, 48, 64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(cuda, B, S, D):
    q, k, v, dout = _inputs(B, S, D, seed=S + D)
    return tuple(x.to(torch.bfloat16).to(cuda) for x in (q, k, v, dout))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D", K2_WIDTHS)
@pytest.mark.parametrize("S", K2_LENGTHS)
def test_bf16_kernels_match_plain(cuda, S, D, rate):
    """Forward (with its lse and float32 output) and backward at bf16 against the plain version on
    the same card; each call is a launch of the bf16 kernel, none of the float32 one."""
    B = 4 if S == 3531 else 2
    q, k, v, dout = _card_inputs(cuda, B, S, D)
    counts = (t_attention.self_attention_fwd.launches, t_attention.self_attention_bwd.launches,
              t_attention.self_attention_bf16_fwd.launches, t_attention.self_attention_bf16_bwd.launches)
    out, lse, out32 = t_attention.self_attention_fwd(q, k, v, rate, 123, return_lse=True, return_out32=True)
    want32 = t_attention._attend(q, k, v, 123, rate)
    assert out.dtype == torch.bfloat16 and lse.dtype == out32.dtype == torch.float32
    torch.testing.assert_close(out, want32.to(torch.bfloat16), **K2_BF16_TOL)
    torch.testing.assert_close(out32, want32, **K2_OUT32_TOL)
    s = torch.einsum("bqd,bkd->bqk", q.float() * D**-0.5, k.float())
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-5, atol=1e-5)
    got = t_attention.self_attention_bwd(q, k, v, out32, dout, lse, rate, 123)
    want = t_attention.attention_bwd_reference(q, k, v, dout, 123, rate)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g, w, **K2_BF16_BWD_TOL)
    assert counts[0] == t_attention.self_attention_fwd.launches and counts[1] == t_attention.self_attention_bwd.launches
    assert t_attention.self_attention_bf16_fwd.launches == counts[2] + 1
    assert t_attention.self_attention_bf16_bwd.launches == counts[3] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(2, 300), (4, 3531)])
def test_bf16_kernels_are_deterministic(cuda, B, S):
    """No atomics: two launches of the forward and the backward agree bit for bit."""
    q, k, v, dout = _card_inputs(cuda, B, S, 48)
    runs = []
    for _ in range(2):
        out, lse, out32 = t_attention.self_attention_fwd(q, k, v, 0.1, 77, return_lse=True, return_out32=True)
        runs.append((out, lse, out32, *t_attention.self_attention_bwd(q, k, v, out32, dout, lse, 0.1, 77)))
    for a, b, name in zip(*runs, ("out", "lse", "out32", "dq", "dk", "dv")):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_bf16_autograd_on_card_matches_cpu(cuda):
    q, k, v, dout = _inputs(2, 200, 48)
    grads = []
    for dev in ("cpu", cuda):
        leaves = [x.to(torch.bfloat16).to(dev).requires_grad_(True) for x in (q, k, v)]
        out = t_attention.self_attention(*leaves, 5, 0.1)
        assert out.dtype == torch.bfloat16
        out.backward(dout.to(torch.bfloat16).to(dev))
        grads.append([t.grad.cpu() for t in leaves])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, **K2_BF16_BWD_TOL)


@pytest.mark.cuda
def test_bf16_wrappers_refuse_what_they_do_not_run(cuda):
    q, k, v, dout = _card_inputs(cuda, 2, 64, 48)
    with pytest.raises(TypeError):  # a dtype mix
        t_attention.self_attention_fwd(q, k.float(), v)
    with pytest.raises(TypeError):
        t_attention.self_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):  # a head width the kernels are not built for
        t_attention.self_attention_fwd(*(x[..., :40].contiguous() for x in (q, k, v)))
    with pytest.raises(ValueError):  # not contiguous
        t_attention.self_attention_fwd(q.transpose(0, 1).contiguous().transpose(0, 1), k, v)
    out, lse, out32 = t_attention.self_attention_fwd(q, k, v, return_lse=True, return_out32=True)
    with pytest.raises(ValueError):  # the backward takes the float32 output, not the bf16 one
        t_attention.self_attention_bwd(q, k, v, out, dout, lse)


@pytest.mark.cuda
def test_layer_norm_of_bf16_with_float32_weights(cuda):
    """The radar transformer's LayerNorm of a bf16 input with float32 weights normalizes in float32
    and rounds to bf16 (flax's LayerNorm(dtype=bf16)), on the card and on the CPU alike. torch's
    own nn.LayerNorm is no substitute: on the card (torch 2.11) it refuses the dtype mix with a
    RuntimeError, where on the CPU it returns bf16; where it runs, it agrees to one bf16 unit."""
    from neuradar_tpu_torch.model_components.radar_decoder import _layer_norm

    x = torch.from_numpy(np.random.RandomState(4).normal(size=(64, 48)).astype(np.float32)).to(torch.bfloat16)
    ln = torch.nn.LayerNorm(48, eps=1e-6)
    with torch.no_grad():
        ln.weight.uniform_(0.5, 1.5)
        ln.bias.uniform_(-0.1, 0.1)
    results = []
    for dev in ("cpu", cuda):
        ln.to(dev)
        want = torch.nn.functional.layer_norm(x.to(dev).float(), (48,), ln.weight, ln.bias, 1e-6).to(torch.bfloat16)
        got = _layer_norm(ln, x.to(dev))
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
        results.append(got.cpu())
        try:
            native = ln(x.to(dev))
        except RuntimeError:
            continue
        torch.testing.assert_close(native, want, rtol=BF16_ULP, atol=0)
    torch.testing.assert_close(results[1], results[0], rtol=BF16_ULP, atol=0)
