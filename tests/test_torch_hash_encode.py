"""The hash-grid encode as one CUDA op (K4, ``ops/hash_encode.py``, ``csrc/hash_encode.cu``).

On the CPU: CPU tensors take the plain path and launch no kernel; the host-rounded level
scalings are ``torch.tensor(scalings, dtype=)``'s; an untemplated grid runs the plain path on the CPU and
has no kernel; ``corner_rows`` gives the plain path's corner gradients bit for bit; and the float64
evaluation of the positions' gradient (``encodings.positions_grad_float64``) is autograd's at float64.
The tests marked ``cuda`` hold the kernel on the card: its forward bit-equal to the plain path at every
preset's grid, the table's gradient within ``float64_sum``'s bound (colliding rows, one row hit by
thousands of contributions, several level groups, subnormals, rays of consecutive samples whose runs in
one cell are summed before one atomic), exact-zero rows leaving the result bit-identical (in random and in
ray order), the card's counts of contributions and atomics (fewer atomics in ray order, one a contribution
where no neighbours share a cell), the positions' gradient no further from the float64 evaluation than
plain autograd's and bit-identical with the counts on or off, an encode's backward launching the kernel
and no torch indexing or scatter operator, and the refusal of what the kernel does not run. They skip
without a card; this file imports no JAX:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_hash_encode.py
"""

import ctypes

import pytest
import torch

from neuradar_tpu_torch.field_components import encodings
from neuradar_tpu_torch.ops import build
from neuradar_tpu_torch.ops import hash_encode as t_encode
from neuradar_tpu_torch.ops import hash_scatter as t_scatter
from neuradar_tpu_torch.utils import trace

DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["float32", "bf16"]
# every preset's grids: (d, F, log2 T, L, base resolution, max resolution); neurad's, neuradar's and
# neuradar-vod's fields and proposal fields (the static and the actor grid each), neurader's
# static grids, one resolution and one hashmap bit up, and nerfacto-huge's field and proposal grids
# (float32 rows of 2 features; the camera optimizer asks for the positions' gradient on each)
GRIDS = {
    "field_static": (3, 4, 22, 8, 32, 8192),
    "field_actor": (4, 4, 17, 4, 64, 1024),
    "proposal_static": (3, 1, 20, 6, 128, 4096),
    "proposal_actor": (4, 1, 15, 4, 64, 1024),
    "neurader_field_static": (3, 4, 23, 8, 64, 16384),
    "nerfacto_huge_field": (3, 2, 21, 16, 16, 8192),
    "nerfacto_huge_proposal_0": (3, 2, 17, 5, 16, 512),
    "nerfacto_huge_proposal_1": (3, 2, 17, 7, 16, 2048),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _encoder(dims, F, dtype, device="cpu", log2_hashmap_size=6, num_levels=4, min_res=4, max_res=64, seed=0):
    enc = encodings.HashEncoding(num_levels=num_levels, min_res=min_res, max_res=max_res,
                                 log2_hashmap_size=log2_hashmap_size, features_per_level=F, n_input_dims=dims,
                                 compute_dtype=None if dtype == torch.float32 else dtype)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        enc.hash_table.copy_(torch.rand(enc.hash_table.shape, generator=gen) * 2 - 1)
    return enc.to(device)


def _plain(enc, positions, table=None):
    """The plain path of ``enc`` on ``positions`` (any device), as ``HashEncoding.forward`` runs it."""
    table = enc.hash_table if table is None else table
    R = enc.compute_dtype or positions.dtype
    out = encodings.hash_encode(positions.to(R), table.to(R), enc.scalings, enc.table_size, enc.num_levels,
                                enc.features_per_level)
    return out.to(positions.dtype)


def _contributions(enc, positions, grad_out):
    """The plain path's corner gradients of the table and their rows: ``grad`` rounded to R times each
    corner's weight, in R."""
    R = enc.compute_dtype or positions.dtype
    N, L, F = positions.shape[0], enc.num_levels, enc.features_per_level
    rows = encodings.corner_rows(positions.to(R), enc.scalings, enc.table_size, L)
    g = grad_out.to(R).reshape(N, L, F)
    return [g * w[..., None] for _, w in rows], [i for i, _ in rows]


def position_grad_formula(enc, positions, table, grad_out):
    """``encodings.positions_grad_float64`` of ``enc``'s encode in its compute type R."""
    R = enc.compute_dtype or positions.dtype
    return encodings.positions_grad_float64(positions.to(R), table.to(R), enc.scalings, enc.table_size,
                                            enc.num_levels, grad_out)


def _rel_l2(got, want) -> float:
    return float((got.double() - want).norm() / want.norm())


# ---------------------------------------------------------------------------------------------- CPU


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("dims", [3, 4])
def test_cpu_encode_takes_the_plain_path(dims, dtype):
    """CPU tensors take the plain path: one encode, no kernel launches, and the output is the plain
    formulation's."""
    enc = _encoder(dims, 2, dtype)
    positions = torch.rand((50, dims), generator=torch.Generator().manual_seed(dims))
    with trace.recording():
        out = enc(positions)
    snap = trace.snapshot()
    assert [s.name for s in snap.spans].count("hash_encode") == 1
    assert (snap.total("launches/hash_encode_fwd"), snap.total("launches/hash_encode_bwd")) == (0, 0)
    assert torch.equal(out, _plain(enc, positions))


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("grid", list(GRIDS) + ["default"])
def test_host_scalings_round_as_torch_tensor(grid, dtype):
    """The kernel's scalings, rounded once on the host a dtype, are ``torch.tensor(scalings, dtype=)``'s:
    float32 keeps them; in bf16 the field's fine levels do round."""
    if grid == "default":
        enc = encodings.HashEncoding(log2_hashmap_size=4)
    else:
        d, F, _, L, lo, hi = GRIDS[grid]
        enc = encodings.HashEncoding(num_levels=L, min_res=lo, max_res=hi, log2_hashmap_size=4,
                                     features_per_level=F, n_input_dims=d)
    got = enc.host_scalings(dtype)
    assert got is enc.host_scalings(dtype)  # made once
    assert got == tuple(torch.tensor(enc.scalings, dtype=dtype).float().tolist())
    if dtype == torch.float32:
        assert got == tuple(enc.scalings)
    elif grid == "field_static":
        assert got != tuple(enc.scalings)


@pytest.mark.parametrize("case", [
    dict(dims=2), dict(dims=5), dict(features_per_level=3), dict(features_per_level=8), dict(num_levels=33),
    dict(num_levels=0), dict(table_dtype=torch.float16), dict(table_dtype=torch.float64),
    dict(pos_dtype=torch.bfloat16), dict(pos_dtype=torch.float16), dict(pos_dtype=torch.float64)])
def test_untemplated_grids_fall_back(case):
    """A grid or dtype the kernel has no template for: every preset's grid has one, in both compute types.
    On the CPU such a grid runs the plain path, as every CPU encode does; ``check`` refuses CPU tensors
    (on the card it refuses an untemplated grid: ``test_kernel_refuses_what_it_does_not_run``)."""
    base = dict(dims=3, features_per_level=4, num_levels=8, table_dtype=torch.bfloat16, pos_dtype=torch.float32)
    assert t_encode.templated(**base)
    assert not t_encode.templated(**{**base, **case})
    for d, F, _, L, _, _ in GRIDS.values():
        for dtype in DTYPES:
            assert t_encode.templated(d, F, L, dtype, torch.float32)
    with pytest.raises(ValueError):
        t_encode.check(torch.zeros((4, 3)), torch.zeros(4 * 8 * 16), 8, 4)
    enc = _encoder(3, 3, torch.float32)
    with trace.recording():
        out = enc(torch.rand((20, 3), generator=torch.Generator().manual_seed(1)))
    snap = trace.snapshot()
    assert [s.name for s in snap.spans].count("hash_encode") == 1 and out.shape == (20, 12)
    assert snap.total("launches/hash_encode_fwd") == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("dims", [3, 4])
def test_corner_rows_give_the_plain_corner_gradients(dims, dtype, monkeypatch):
    """``corner_rows``' weights times the gradient rounded to R are the corner gradients the plain
    path's ``_CornerGather`` hands its scatter, bit for bit, with the same rows."""
    enc = _encoder(dims, 4, dtype)
    gen = torch.Generator().manual_seed(7)
    positions = torch.rand((200, dims), generator=gen)
    grad_out = torch.randn((200, enc.get_out_dim()), generator=gen)
    seen = []

    def scatter(grads, idxs, table_shape):
        seen.append(([g.clone() for g in grads], [i.clone() for i in idxs]))
        return t_scatter.hash_scatter_reference(grads, idxs, table_shape)

    monkeypatch.setattr(encodings, "hash_scatter_reference", scatter)
    enc(positions).backward(grad_out)
    ((grads, idxs),) = seen
    want_grads, want_idxs = _contributions(enc, positions, grad_out)
    assert all(torch.equal(a, b) for a, b in zip(idxs, want_idxs))
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(grads, want_grads))


@pytest.mark.parametrize("F", [1, 4])
@pytest.mark.parametrize("dims", [3, 4])
def test_position_gradient_formula_is_autograds_at_float64(dims, F):
    """The backward's formula for the positions' gradient agrees with autograd of the plain path at
    float64 (positions and table in float64, no compute dtype). The plain path sums its corner terms in
    float32, whose backward casts the gradient to float32: float32 values of the gradient keep it
    exact."""
    enc = _encoder(dims, F, torch.float32, log2_hashmap_size=8, seed=dims * F)
    table = enc.hash_table.detach().double()
    gen = torch.Generator().manual_seed(11)
    positions = torch.rand((300, dims), generator=gen, dtype=torch.float64)
    grad_out = torch.randn((300, enc.get_out_dim()), generator=gen).double()
    pos = positions.clone().requires_grad_(True)
    out = encodings.hash_encode(pos, table, enc.scalings, enc.table_size, enc.num_levels, F)
    (want,) = torch.autograd.grad(out, pos, grad_out)
    got = position_grad_formula(enc, positions, table, grad_out)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * float(want.abs().max()))
    assert float(want.abs().max()) > 0


# --------------------------------------------------------------------------------------------- card


def _grid_encoder(name, dtype, device, seed=0):
    d, F, log2_t, L, lo, hi = GRIDS[name]
    enc = encodings.HashEncoding(num_levels=L, min_res=lo, max_res=hi, log2_hashmap_size=log2_t,
                                 features_per_level=F, n_input_dims=d,
                                 compute_dtype=None if dtype == torch.float32 else dtype).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        enc.hash_table.copy_((torch.rand(enc.hash_table.shape, generator=gen, device=device) * 2 - 1) * 0.1)
    return enc


def _points(device, N, d, seed):
    """Points of a contracted scene: most in [0, 1], a few on its faces and a little outside."""
    gen = torch.Generator(device=device).manual_seed(seed)
    p = torch.rand((N, d), generator=gen, device=device) * 1.02 - 0.01
    p[: N // 64] = torch.randint(0, 2, (N // 64, d), generator=gen, device=device).float()
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("grid", list(GRIDS))
def test_forward_bit_equal_to_plain(cuda, grid, dtype, grad):
    """The kernel's output equals the plain path's on the card bit for bit, at every preset's grid, in
    both compute types, with gradients on and off; one launch (``launches/hash_encode_fwd``)."""
    enc = _grid_encoder(grid, dtype, cuda)
    positions = _points(cuda, 1 << 16, enc.n_input_dims, seed=3)
    if grad:
        positions.requires_grad_(True)
    with torch.set_grad_enabled(grad), trace.recording():
        got = enc(positions)
    assert trace.snapshot().total("launches/hash_encode_fwd") == 1
    assert got.requires_grad == grad
    with torch.no_grad():
        want = _plain(enc, positions.detach())
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got.detach(), want), int((got != want).sum())


def _hot_points(device, N, d, seed, exact=False):
    """N points: a quarter on one point (thousands of contributions on one row of each level), the rest
    in a small box, so rows collide; ``exact``: every coordinate a multiple of 1/4, on a cell corner of
    every level of scalings 4, 8, 16."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if exact:
        p = torch.randint(0, 4, (N, d), generator=gen, device=device).float() / 4
    else:
        p = torch.rand((N, d), generator=gen, device=device) * 0.3 + 0.2
    hot = torch.rand(N, generator=gen, device=device) < 0.25
    return torch.where(hot[:, None], p[:1].expand_as(p), p)


def _grad_out(device, N, width, seed, integer=False):
    """Gradients of the output [N, width], a fifth of the (point, level) rows exact zeros, half of those
    -0; ``integer``: -1, 0 or 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if integer:
        g = torch.randint(-1, 2, (N, width), generator=gen, device=device).float()
    else:
        g = torch.randn((N, width), generator=gen, device=device)
    zero = torch.rand((N, width), generator=gen, device=device) < 0.2
    sign = torch.where(torch.rand((N, width), generator=gen, device=device) < 0.5, -1.0, 1.0)
    return torch.where(zero, 0.0 * sign, g)


def _table_grad(enc, positions, grad_out):
    enc.hash_table.grad = None
    enc(positions).backward(grad_out)
    return enc.hash_table.grad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("dims,F", [(3, 1), (3, 2), (3, 4), (4, 1), (4, 4)])
def test_table_gradient_within_float64_sum(cuda, dims, F, dtype, monkeypatch):
    """The table's gradient against the exact sum of the plain path's corner gradients, within
    ``float64_sum``'s bound (the atomics add in an order that changes from run to run; a bf16 gradient
    rounds once); a row no contribution reaches reads exactly 0. The accumulator is shrunk so that a
    bf16 table takes several launches, one level each."""
    monkeypatch.setattr(t_encode, "SCRATCH_FLOATS", 64 * F)
    N, L = 3000, 3
    enc = _encoder(dims, F, dtype, device=cuda, num_levels=L)
    positions = _hot_points(cuda, N, dims, seed=dims * F)
    grad_out = _grad_out(cuda, N, L * F, seed=dims + F)
    with trace.recording():
        got = _table_grad(enc, positions, grad_out)
        torch.cuda.synchronize()
    snap = trace.snapshot()
    assert snap.total("launches/hash_encode_fwd") == 1
    assert snap.total("launches/hash_encode_bwd") == (L if dtype == torch.bfloat16 else 1)
    shape = (L * enc.table_size, F)
    grads, idxs = _contributions(enc, positions, grad_out)
    rows = torch.cat([i.reshape(-1) for i in idxs])
    assert int(torch.bincount(rows).max()) > 1000
    exact, bound = t_scatter.float64_sum(grads, idxs, shape)
    # the float32 parameter's gradient is the R gradient, cast exactly
    err = (got.view(shape).double() - exact).abs()
    assert bool((err <= bound).all()), float((err - bound).max())
    reached = torch.zeros(shape[0], dtype=torch.bool, device=cuda).index_fill_(0, rows, True)
    assert bool((got.view(shape)[~reached] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_table_gradient_subnormals_within_the_bound(cuda, dtype):
    """Contributions under 2^-126, subnormal in float32: the card's float32 atomics flush them to zero,
    and ``float64_sum``'s bound allows 2^-125 an add for it."""
    N, L, F = 500, 2, 4
    enc = _encoder(3, F, dtype, device=cuda, num_levels=L)
    positions = _hot_points(cuda, N, 3, seed=11)
    grad_out = _grad_out(cuda, N, L * F, seed=11) * 2.0**-135
    grads, idxs = _contributions(enc, positions, grad_out)
    assert all(bool((g.float().abs() < 2.0**-126).all()) for g in grads) and any(bool((g != 0).any()) for g in grads)
    got = _table_grad(enc, positions, grad_out)
    exact, bound = t_scatter.float64_sum(grads, idxs, (L * enc.table_size, F))
    assert bool(((got.view(-1, F).double() - exact).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("dims,F", [(3, 4), (4, 1)])
def test_zero_rows_leave_the_result_bit_identical(cuda, dims, F, dtype):
    """Points on cell corners (every weight 1 or 0) and gradients of -1, 0 or 1, whose sums here are
    exact in float32 and bf16 in any order: the kernel equals the plain path's scatter bit for bit,
    though it skips the exact-zero rows (+0 or -0: the zero weights' and a fifth of the gradients) that
    the plain path adds; rows turned into -0 still match it, and an element that only -0 rows reach
    reads +0, as the plain path's zero table plus -0 does."""
    N, L = 500, 3
    enc = _encoder(dims, F, dtype, device=cuda, num_levels=L, min_res=4, max_res=16)
    assert enc.scalings == (4.0, 8.0, 16.0)
    positions = _hot_points(cuda, N, dims, seed=7, exact=True)
    grad_out = _grad_out(cuda, N, L * F, seed=7, integer=True)
    R = enc.compute_dtype or torch.float32
    assert not bool(encodings._cells(positions.to(R), enc.scalings)[1].any())
    shape = (L * enc.table_size, F)
    for g in (grad_out, torch.where(grad_out > 0, torch.full_like(grad_out, -0.0), grad_out)):
        grads, idxs = _contributions(enc, positions, g)
        plain = t_scatter.hash_scatter_reference(grads, idxs, shape)
        got = _table_grad(enc, positions, g).view(shape).to(plain.dtype)
        assert torch.equal(got, plain)
        assert not bool((torch.signbit(got) & (got == 0)).any())
    assert bool((got == 0).any()) and bool((got != 0).any())


def _ray_points(device, rays, samples, d, seed, exact=False):
    """[rays * samples, d] points in ray order, as a model's samples reach the encode: each ray from an origin
    in [0.1, 0.9]^3 over a length of up to 0.9, its samples sorted by depth, clamped to [0, 1]; a 4-D point's
    last coordinate (the actor's) fixed a ray. ``exact``: each coordinate floored to a multiple of 1/4, a cell
    corner of every level of scalings 4, 8, 16."""
    gen = torch.Generator(device=device).manual_seed(seed)
    origin = torch.rand((rays, 1, 3), generator=gen, device=device) * 0.8 + 0.1
    direction = torch.nn.functional.normalize(torch.randn((rays, 1, 3), generator=gen, device=device), dim=-1)
    depth = torch.rand((rays, samples, 1), generator=gen, device=device).sort(dim=1).values * 0.9
    p = (origin + depth * direction).clamp(0, 1)
    if d == 4:
        p = torch.cat([p, torch.rand((rays, 1, 1), generator=gen, device=device).expand(rays, samples, 1)], dim=-1)
    if exact:
        p = torch.floor(p * 4) / 4
    return p.reshape(rays * samples, d).contiguous()


def _bwd_counts(enc, positions, grad_out, pos_grad=False):
    """The kernel's backward of ``enc`` on ``positions`` inside a recording: the table's gradient, the
    positions' (or None) and the counts (nonzero contributions, atomics) the launches made on the card."""
    R = enc.compute_dtype or torch.float32
    scal = enc.host_scalings(R)
    with trace.recording():
        gp, gt = t_encode.hash_encode_bwd(grad_out, positions, enc.hash_table.detach().to(R).contiguous(), scal,
                                          enc.table_size, enc.num_levels, enc.features_per_level, pos_grad, True)
        snap = trace.snapshot()
    return gt, gp, (snap.total("hash_encode/bwd_contributions"), snap.total("hash_encode/bwd_atomics"))


def _nonzero_contributions(grads) -> int:
    return sum(int((g != 0).any(dim=-1).sum()) for g in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [64 * 512, 64 * 512 - 7])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("grid", ["nerfacto_huge_proposal_0", "nerfacto_huge_proposal_1", "nerfacto_huge_field",
                                  "field_static"])
def test_ray_ordered_runs_within_float64_sum(cuda, grid, dtype, N):
    """Rays of 512 consecutive samples sorted by depth: at the coarse levels runs of neighbouring lanes lie
    in one cell and each run adds its corners' sum with one atomic; every other ray's gradient is exact
    zeros (as an actor grid's outside its box), whose warps skip the level. The table's gradient stays
    within ``float64_sum``'s bound, the card counts every nonzero contribution, and fewer atomics than
    those. With N no multiple of 32 the last ray is cut inside a warp: its lanes past N join no run."""
    enc = _grid_encoder(grid, dtype, cuda, seed=2)
    positions = _ray_points(cuda, 64, 512, enc.n_input_dims, seed=4)[:N].contiguous()
    grad_out = _grad_out(cuda, 64 * 512, enc.get_out_dim(), seed=4)
    grad_out.view(64, 512, -1)[::2] = 0
    grad_out = grad_out[:N].contiguous()
    gt, _, (contributions, atomics) = _bwd_counts(enc, positions, grad_out)
    grads, idxs = _contributions(enc, positions, grad_out)
    assert contributions == _nonzero_contributions(grads) > 0
    assert 0 < atomics < contributions, (atomics, contributions)
    exact, bound = t_scatter.float64_sum(grads, idxs, (enc.num_levels * enc.table_size, enc.features_per_level))
    err = (gt.view(exact.shape).double() - exact).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("dims,F", [(3, 1), (3, 2), (3, 4), (4, 1), (4, 4)])
def test_scattered_rows_take_one_atomic_a_contribution(cuda, dims, F, dtype):
    """Neighbouring points in far halves of the first axis (0 to 1/4 and 3/4 to 1): no two neighbouring
    lanes share a cell at any level, so every level takes the per-lane atomics, exactly one a nonzero
    contribution, and the gradient stays within ``float64_sum``'s bound. N is no multiple of 32: the last
    warp's lanes past N add nothing."""
    N, L = 3001, 4
    enc = _encoder(dims, F, dtype, device=cuda, num_levels=L, log2_hashmap_size=10)
    gen = torch.Generator(device=cuda).manual_seed(dims * F)
    positions = torch.rand((N, dims), generator=gen, device=cuda)
    positions[:, 0] = positions[:, 0] * 0.25 + 0.75 * (torch.arange(N, device=cuda) % 2)
    grad_out = _grad_out(cuda, N, L * F, seed=dims * F)
    gt, _, (contributions, atomics) = _bwd_counts(enc, positions, grad_out)
    grads, idxs = _contributions(enc, positions, grad_out)
    assert atomics == contributions == _nonzero_contributions(grads) > 0
    exact, bound = t_scatter.float64_sum(grads, idxs, (L * enc.table_size, F))
    assert bool(((gt.view(exact.shape).double() - exact).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("dims,F", [(3, 4), (4, 1)])
def test_ray_ordered_zero_rows_leave_the_result_bit_identical(cuda, dims, F, dtype):
    """``test_zero_rows_leave_the_result_bit_identical`` in ray order: rays of points on cell corners and
    gradients of -1, 0 or 1, so that runs of lanes sum their rows in registers first. The sums are exact in
    any order, so the kernel equals the plain path's scatter bit for bit; a run whose sum is an exact zero
    (+0 or -0) adds nothing, and no element reads -0."""
    L = 3
    enc = _encoder(dims, F, dtype, device=cuda, num_levels=L, min_res=4, max_res=16)
    assert enc.scalings == (4.0, 8.0, 16.0)
    positions = _ray_points(cuda, 16, 64, dims, seed=8, exact=True)
    grad_out = _grad_out(cuda, positions.shape[0], L * F, seed=8, integer=True)
    shape = (L * enc.table_size, F)
    for g in (grad_out, torch.where(grad_out > 0, torch.full_like(grad_out, -0.0), grad_out)):
        grads, idxs = _contributions(enc, positions, g)
        plain = t_scatter.hash_scatter_reference(grads, idxs, shape)
        gt, _, (contributions, atomics) = _bwd_counts(enc, positions, g)
        got = gt.view(shape).to(plain.dtype)
        assert torch.equal(got, plain)
        assert not bool((torch.signbit(got) & (got == 0)).any())
        assert atomics < contributions == _nonzero_contributions(grads)
    assert bool((got == 0).any()) and bool((got != 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("grid", ["nerfacto_huge_proposal_0", "nerfacto_huge_field", "field_actor"])
def test_positions_gradient_bit_identical_with_counts(cuda, grid, dtype):
    """The positions' gradient does not depend on the counts: in ray order, the backward's positions'
    gradient with the counting buffer (inside a recording) equals the one without it bit for bit."""
    enc = _grid_encoder(grid, dtype, cuda, seed=6)
    positions = _ray_points(cuda, 32, 512, enc.n_input_dims, seed=6)
    grad_out = _grad_out(cuda, positions.shape[0], enc.get_out_dim(), seed=6)
    R = enc.compute_dtype or torch.float32
    table = enc.hash_table.detach().to(R).contiguous()
    args = (grad_out, positions, table, enc.host_scalings(R), enc.table_size, enc.num_levels,
            enc.features_per_level, True, True)
    assert not trace.counting_device()
    gp_plain, _ = t_encode.hash_encode_bwd(*args)
    _, gp, (contributions, atomics) = _bwd_counts(enc, positions, grad_out, pos_grad=True)
    assert 0 < atomics < contributions
    assert torch.equal(gp, gp_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("grid", list(GRIDS))
def test_positions_gradient_no_further_from_float64(cuda, grid, dtype):
    """The positions' gradient (float64 sums, one rounding) is no further from the float64 evaluation of
    ``position_grad_formula`` than plain autograd's gradient in the same compute type is (relative L2);
    the table's gradient comes with it, within ``float64_sum``'s bound, in one launch a level group."""
    enc = _grid_encoder(grid, dtype, cuda, seed=5)
    N = 1 << 15
    positions = _points(cuda, N, enc.n_input_dims, seed=9)
    grad_out = _grad_out(cuda, N, enc.get_out_dim(), seed=9)
    pos = positions.clone().requires_grad_(True)
    enc.hash_table.grad = None
    with trace.recording():
        enc(pos).backward(grad_out)
    table_grad = enc.hash_table.grad.clone()
    per = t_encode.levels_per_launch(enc.table_size, enc.features_per_level, enc.num_levels,
                                     enc.compute_dtype or torch.float32)
    assert trace.snapshot().total("launches/hash_encode_bwd") == -(-enc.num_levels // per)
    want = position_grad_formula(enc, positions, enc.hash_table.detach(), grad_out)
    plain = positions.clone().requires_grad_(True)
    _plain(enc, plain).backward(grad_out)
    err, err_plain = _rel_l2(pos.grad, want), _rel_l2(plain.grad, want)
    assert err <= err_plain, (err, err_plain)
    grads, idxs = _contributions(enc, positions, grad_out)
    exact, bound = t_scatter.float64_sum(grads, idxs, (enc.num_levels * enc.table_size, enc.features_per_level))
    assert bool(((table_grad.view(exact.shape).double() - exact).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("dims", [3, 4])
def test_encode_backward_runs_the_kernel(cuda, dims, dtype):
    """An encode on the card: one launch forward, one backward, its rows counted, no torch indexing or
    scatter operator; the output is the CPU's bit for bit, the table's gradient the float64 sum of the
    corners' gradients within ``float64_sum``'s bound, and the positions' gradient no further from the
    float64 evaluation than the CPU's plain autograd."""
    enc = _encoder(dims, 4, dtype, log2_hashmap_size=10, seed=10 * dims + 4)
    gen = torch.Generator().manual_seed(10 * dims + 4)
    positions = torch.rand((300, dims), generator=gen)
    weights = torch.randn((300, enc.get_out_dim()), generator=gen)
    cpu_pos = positions.clone().requires_grad_(True)
    cpu_out = enc(cpu_pos)
    cpu_out.backward(weights)
    enc = enc.to(cuda)
    enc.hash_table.grad = None
    pos = positions.to(cuda).requires_grad_(True)
    with trace.recording(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = enc(pos)
        out.backward(weights.to(cuda))
        torch.cuda.synchronize()
    snap = trace.snapshot()
    assert (snap.total("launches/hash_encode_fwd"), snap.total("launches/hash_encode_bwd")) == (1, 1)
    assert snap.total("hash_scatter_rows") == 2**dims * 300 * 4
    assert "host_sync/hash_scalings" not in {s.name for s in snap.spans}
    (span,) = [s for s in snap.spans if s.name == "hash_encode/scatter"]
    assert span.device_ms is not None and span.device_ms > 0
    names = {e.key for e in prof.key_averages()}
    assert not {n for n in names if any(k in n for k in ("index_put", "index_add", "scatter_add", "index"))}, names
    assert torch.equal(out.detach().cpu(), cpu_out.detach())
    grads, idxs = _contributions(enc, positions.to(cuda), weights.to(cuda))
    exact, bound = t_scatter.float64_sum(grads, idxs, (enc.num_levels * enc.table_size, 4))
    assert bool(((enc.hash_table.grad.view(exact.shape).double() - exact).abs() <= bound).all())
    want = position_grad_formula(enc, positions.to(cuda), enc.hash_table.detach(), weights.to(cuda))
    assert _rel_l2(pos.grad, want) <= _rel_l2(cpu_pos.grad.to(cuda), want)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_run(cuda):
    """On the card there is no fallback: ``check`` and the encode refuse what the kernel has no template
    or layout for (an untemplated F or d, a dtype, CUDA tensors on two devices, a table not aligned to its
    rows), and so does an encoder without a compute dtype whose positions are not in its table's dtype;
    the launcher itself refuses an untemplated grid with an error code."""
    table = torch.zeros(8 * 16 * 4, device=cuda, dtype=torch.bfloat16)
    pos = torch.zeros((10, 3), device=cuda)
    t_encode.check(pos, table, 8, 4)
    for args, error in (((pos.bfloat16(), table, 8, 4), TypeError), ((pos, table.half(), 8, 4), TypeError),
                        ((pos[:, :2].contiguous(), table, 8, 4), TypeError), ((pos, table, 8, 3), TypeError),
                        ((pos, table, 33, 4), TypeError), ((pos, table.cpu(), 8, 4), ValueError),
                        ((pos, table[1:], 8, 4), ValueError), ((pos, table[::2], 8, 2), ValueError)):
        with pytest.raises(error):
            t_encode.check(*args)
    scal = (1.0,) * 8
    with pytest.raises(ValueError):  # not aligned to its rows: the encode does not copy it
        t_encode.hash_encode(pos, table[1:-3], scal, 16, 8, 4)
    for dims, F in ((3, 3), (2, 4)):
        enc = _encoder(dims, F, torch.bfloat16, device=cuda)
        with pytest.raises(TypeError):
            enc(torch.rand((10, dims), device=cuda))
    enc = _encoder(3, 4, torch.float32, device=cuda)
    with pytest.raises(TypeError):
        enc(torch.rand((10, 3), device=cuda, dtype=torch.float64))
    out = torch.empty((10, 24), device=cuda)
    c_scal = (ctypes.c_float * 8)(*range(8))
    stream = torch.cuda.current_stream(cuda).cuda_stream
    code = build.load().hash_encode_fwd(pos.data_ptr(), table.data_ptr(), 1, out.data_ptr(), c_scal, 10, 3, 8, 3,
                                        16, stream)
    assert code != 0
    with pytest.raises(RuntimeError):
        build.check(code, "hash_encode_fwd")
