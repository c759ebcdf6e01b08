"""The hash tables' gradient scatter (K4's backward, ``ops/hash_scatter.py``, ``csrc/hash_scatter.cu``).

On the CPU an encode's ``_CornerGather`` gives the forward, the table's gradient and the positions'
gradient of plain autograd through one ``table[idx]`` a corner, bit for bit, at every grid shape the
presets use (d 3 or 4, F 1, 2 or 4, float32 or bf16 tables). The tests marked ``cuda`` hold the kernel
against a float64 sum on the card: colliding indices, one row hit by thousands of contributions,
exact-zero rows, both dtypes, several level groups; and the encode's backward on the card launches the
kernel and no torch indexing or scatter operator. They skip without a card; this file imports no JAX:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_hash_scatter.py
"""

import pytest
import torch

from neuradar_tpu_torch.field_components import encodings
from neuradar_tpu_torch.ops import hash_scatter as t_scatter
from neuradar_tpu_torch.utils import trace

DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["float32", "bf16"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _encoder(dims, F, dtype, device="cpu", log2_hashmap_size=6):
    enc = encodings.HashEncoding(num_levels=4, min_res=4, max_res=64, log2_hashmap_size=log2_hashmap_size,
                                 features_per_level=F, n_input_dims=dims,
                                 compute_dtype=None if dtype == torch.float32 else dtype).to(device)
    gen = torch.Generator().manual_seed(10 * dims + F)
    with torch.no_grad():
        enc.hash_table.copy_(torch.rand(enc.hash_table.shape, generator=gen) * 2 - 1)
    positions = torch.rand((300, dims), generator=gen).to(device)
    weights = torch.randn((300, enc.get_out_dim()), generator=gen).to(device)
    return enc, positions, weights


def _encode_grads(enc, positions, weights):
    enc.hash_table.grad = None
    pos = positions.clone().requires_grad_(True)
    out = enc(pos)
    (out * weights).sum().backward()
    return out.detach(), enc.hash_table.grad.clone(), pos.grad.clone()


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("F", [1, 2, 4])
@pytest.mark.parametrize("dims", [3, 4])
def test_corner_gather_matches_plain_autograd(dims, F, dtype, monkeypatch):
    """The encode's output, table gradient and position gradient through ``_CornerGather`` equal plain
    autograd's through one ``table[idx]`` a corner, bit for bit: a 64-row table, so corners collide
    and the order in which the corner tables are summed counts."""
    enc, positions, weights = _encoder(dims, F, dtype)
    got = _encode_grads(enc, positions, weights)
    monkeypatch.setattr(encodings, "_gather_corners", lambda table, idxs: [table[i] for i in idxs])
    want = _encode_grads(enc, positions, weights)
    for g, w, name in zip(got, want, ("output", "table gradient", "position gradient")):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert int((got[1] != 0).sum()) > 0 and int((got[2] != 0).sum()) > 0


def test_levels_per_launch_groups_by_the_accumulator():
    """A bf16 table's levels go into launches of at most SCRATCH_FLOATS float32 values (at least one
    level); a float32 table accumulates in its gradient in one launch. The neuradar preset's grids:
    the field's static 8 x 2^22 x 4 one level a launch, the others whole."""
    per = t_scatter.levels_per_launch
    assert per(2**22, 4, 8, torch.bfloat16) == 1
    assert per(2**17, 4, 4, torch.bfloat16) == 4
    assert per(2**20, 1, 6, torch.bfloat16) == 6
    assert per(2**15, 1, 4, torch.bfloat16) == 4
    assert per(2**22, 4, 8, torch.float32) == 8
    assert per(2**23, 4, 8, torch.bfloat16) == 1


def test_hash_scatter_cpu_runs_plain_version():
    gen = torch.Generator().manual_seed(3)
    grads = [torch.randn((50, 2, 3), generator=gen) for _ in range(8)]
    idxs = [torch.randint(0, 16, (50, 2), generator=gen) + torch.tensor([0, 16]) for _ in range(8)]
    before = t_scatter.hash_scatter.launches
    got = t_scatter.hash_scatter(grads, idxs, (32, 3))
    assert t_scatter.hash_scatter.launches == before
    exact, bound = t_scatter.float64_sum(grads, idxs, (32, 3))
    assert bool(((got.double() - exact).abs() <= bound).all()) and float(bound.max()) > 0


def _scatter_inputs(device, C, N, L, T, F, dtype, seed, integer=False):
    """Corner gradients [N, L, F] and indices [N, L] in each level's rows: a quarter of the
    contributions on one row of each level (thousands on one address), the rest on a few rows, so
    indices collide; a fifth of the rows exact zeros, half of those -0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    grads, idxs = [], []
    levels = torch.arange(L, device=device) * T
    for _ in range(C):
        if integer:  # -1, 0 or 1: every sum of them here is exact, in float32 and in bf16, in any order
            g = torch.randint(-1, 2, (N, L, F), generator=gen, device=device).float()
        else:
            g = torch.randn((N, L, F), generator=gen, device=device)
        zero = torch.rand((N, L), generator=gen, device=device) < 0.2
        sign = torch.where(torch.rand((N, L), generator=gen, device=device) < 0.5, -1.0, 1.0)
        g = torch.where(zero[..., None], (0.0 * sign)[..., None].expand_as(g), g)
        rows = torch.randint(0, min(T, 37), (N, L), generator=gen, device=device)
        hot = torch.rand((N, L), generator=gen, device=device) < 0.25
        rows = torch.where(hot, torch.full_like(rows, T - 1), rows)
        grads.append(g.to(dtype))
        idxs.append(rows + levels)
    return grads, idxs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("C,F", [(8, 1), (8, 2), (8, 4), (16, 1), (16, 4), (8, 3)])
def test_hash_scatter_kernel_matches_float64_sum(cuda, C, F, dtype, monkeypatch):
    """The kernel against the exact sum, within ``float64_sum``'s bound (the atomics add in an order
    that changes from run to run; a bf16 gradient rounds once); a row no contribution reaches reads
    exactly 0. The accumulator is shrunk so that a bf16 table takes several launches, one level each."""
    monkeypatch.setattr(t_scatter, "SCRATCH_FLOATS", 64 * F)
    N, L, T = 3000, 3, 64
    grads, idxs = _scatter_inputs(cuda, C, N, L, T, F, dtype, seed=C * F)
    before = t_scatter.hash_scatter.launches
    got = t_scatter.hash_scatter(grads, idxs, (L * T, F))
    torch.cuda.synchronize()
    assert t_scatter.hash_scatter.launches - before == (L if dtype == torch.bfloat16 else 1)
    assert got.dtype == dtype and got.shape == (L * T, F)
    assert int(torch.bincount(torch.cat([i.reshape(-1) for i in idxs])).max()) > 1000
    exact, bound = t_scatter.float64_sum(grads, idxs, (L * T, F))
    err = (got.double() - exact).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_hash_scatter_subnormals_within_the_bound(cuda, dtype):
    """Contributions under 2^-126, subnormal in float32: the card's float32 atomics flush them to zero,
    and ``float64_sum``'s bound allows 2^-125 an add for it."""
    N, L, T = 500, 2, 64
    grads, idxs = _scatter_inputs(cuda, 8, N, L, T, 4, torch.float32, seed=11)
    grads = [(g * 2.0**-135).to(dtype) for g in grads]
    assert all(bool((g.float().abs() < 2.0**-126).all()) and bool((g != 0).any()) for g in grads)
    got = t_scatter.hash_scatter(grads, idxs, (L * T, 4))
    exact, bound = t_scatter.float64_sum(grads, idxs, (L * T, 4))
    assert bool(((got.double() - exact).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("C,F", [(8, 4), (16, 1)])
def test_hash_scatter_zero_rows_leave_the_result_bit_identical(cuda, C, F, dtype):
    """On -1, 0 and 1, whose sums here (under 256 in magnitude) are exact in float32 and bf16 in any
    order, the kernel equals torch's plain path bit for bit, with a fifth of the rows exact zeros
    (+0 or -0) that the kernel skips and the plain path adds; rows turned into -0 still match it, and
    an element that only -0 rows reach reads +0, as the plain path's zero table plus -0 does."""
    N, L, T = 500, 2, 64
    grads, idxs = _scatter_inputs(cuda, C, N, L, T, F, dtype, seed=7, integer=True)
    plain = t_scatter.hash_scatter_reference(grads, idxs, (L * T, F))
    got = t_scatter.hash_scatter(grads, idxs, (L * T, F))
    assert torch.equal(got, plain)
    # the rows on row 5 of each level become -0, and one lone row of level 0 becomes the only
    # contribution to row T - 2, as -0
    neg = [torch.where((i % T == 5)[..., None], torch.full_like(g, -0.0), g) for g, i in zip(grads, idxs)]
    idxs[0][0, 0] = T - 2
    neg[0][0, 0] = -0.0
    got0 = t_scatter.hash_scatter(neg, idxs, (L * T, F))
    want0 = t_scatter.hash_scatter_reference(neg, idxs, (L * T, F))
    assert torch.equal(got0, want0)
    assert torch.equal(got0[5], torch.zeros_like(got0[5])) and not bool(torch.signbit(got0[T - 2]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("dims", [3, 4])
def test_encode_backward_runs_the_kernel(cuda, dims, dtype, monkeypatch):
    """An encode's backward on the card: one launch, its rows counted, no torch indexing or scatter
    operator; the table gradient is the float64 sum of the corners' gradients within
    ``float64_sum``'s bound, and the output and the position gradient are the CPU's up to float32 sums in
    another order (bf16: one bf16 unit; the position gradient's terms cancel, so its float32 bound is
    taken against its largest element)."""
    enc, positions, weights = _encoder(dims, 4, dtype, log2_hashmap_size=10)
    want = _encode_grads(enc, positions, weights)
    enc = enc.to(cuda)
    seen = []

    def scatter(grads, idxs, table_shape):
        seen.append(([g.clone() for g in grads], [i.clone() for i in idxs], table_shape))
        return t_scatter.hash_scatter(grads, idxs, table_shape)

    monkeypatch.setattr(encodings, "hash_scatter", scatter)
    before = t_scatter.hash_scatter.launches
    with trace.recording(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = _encode_grads(enc, positions.to(cuda), weights.to(cuda))
        torch.cuda.synchronize()
    snap = trace.snapshot()
    assert t_scatter.hash_scatter.launches - before == 1
    assert snap.total("hash_scatter_rows") == 2**dims * 300 * 4
    (span,) = [s for s in snap.spans if s.name == "hash_encode/scatter"]
    assert span.device_ms is not None and span.device_ms > 0
    names = {e.key for e in prof.key_averages()}
    assert not {n for n in names if any(k in n for k in ("index_put", "index_add", "scatter_add"))}, names
    ((grads, idxs, table_shape),) = seen
    exact, bound = t_scatter.float64_sum(grads, idxs, table_shape)
    assert bool(((got[1].reshape(table_shape).double() - exact).abs() <= bound).all())
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 else dict(rtol=2.0**-7, atol=1e-6)
    torch.testing.assert_close(got[0].cpu(), want[0], **tol)
    # the position gradient sums its corners' terms, which cancel, in other orders on the card: an
    # element can err by float32 rounding of the largest element
    if dtype == torch.float32:
        tol["atol"] = 2.0**-20 * float(want[2].abs().max())
    torch.testing.assert_close(got[2].cpu(), want[2], **tol)


@pytest.mark.cuda
def test_hash_scatter_refuses_what_it_does_not_run(cuda):
    grads, idxs = _scatter_inputs(cuda, 8, 10, 2, 16, 2, torch.float32, seed=1)
    with pytest.raises(TypeError):
        t_scatter.hash_scatter([g.half() for g in grads], idxs, (32, 2))
    with pytest.raises(TypeError):
        t_scatter.hash_scatter(grads, [i.int() for i in idxs], (32, 2))
    with pytest.raises(ValueError):
        t_scatter.hash_scatter(grads[:6], idxs[:6], (32, 2))
    with pytest.raises(ValueError):
        t_scatter.hash_scatter(grads, idxs, (33, 2))
    with pytest.raises(ValueError):
        t_scatter.hash_scatter([grads[0].cpu(), *grads[1:]], idxs, (32, 2))
