"""Kernels K3 (fused_composite) and P1 (row_gather) of the port.

On the CPU the wrappers run their plain PyTorch versions, which are held here against the JAX
package: K3 against ``fused_composite`` in interpret mode and against the XLA formulation of
tests/test_pallas_ops.py, P1 against the reference of tools/probe_mosaic_gather.py
(``np.asarray(table2d)[idx]``) on the probe's own inputs. The tests marked ``cuda`` hold each CUDA
kernel against its plain version on the card at ragged sizes, and P1's deferred index check (an
index out of range raises at ``check_indices``, never at the launch), and skip without a card;
JAX is imported inside the fixtures only, so they also run where JAX is absent:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels3.py
"""

import numpy as np
import pytest
import torch

from neuradar_tpu_torch.ops import gather as t_gather
from neuradar_tpu_torch.ops import volumetric as t_volumetric
from neuradar_tpu_torch.utils import trace

K3_TOL = dict(rtol=1e-5, atol=1e-6)  # K1's: weights and sums of 32 float32 terms in other orders


def _k3_inputs(R=256, S=32, C=48, seed=0):
    rng = np.random.RandomState(seed)
    alpha = rng.uniform(0.0, 0.9, (R, S)).astype(np.float32)
    feats = rng.normal(size=(R, S, C)).astype(np.float32)
    steps = np.cumsum(rng.uniform(size=(R, S)), axis=-1).astype(np.float32)
    return alpha, feats, steps


@pytest.fixture(scope="module")
def jax_composite():
    import jax.numpy as jnp

    from neuradar_tpu.cameras.rays import render_weights_from_alpha
    from neuradar_tpu.ops.volumetric import fused_composite

    def xla(alpha, feats, steps):
        """tests/test_pallas_ops.py::test_fused_composite_matches_xla's reference."""
        w = render_weights_from_alpha(alpha)
        return (w, jnp.einsum("rs,rsc->rc", w, feats), jnp.sum(w * steps, axis=-1, keepdims=True),
                jnp.sum(w, axis=-1, keepdims=True))

    return (lambda a, f, s: fused_composite(a, f, s, interpret=True)), xla


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("which", ["pallas_interpret", "xla"])
def test_fused_composite_plain_matches_jax(jax_composite, which):
    """The shapes of tests/test_pallas_ops.py (R 256, S 32, C 48); the Pallas kernel's transmittance
    is exp(cumsum(log)), the plain version's a cumprod."""
    fused, xla = jax_composite
    alpha, feats, steps = _k3_inputs()
    want = (fused if which == "pallas_interpret" else xla)(alpha, feats, steps)
    got = t_volumetric.fused_composite(*(torch.from_numpy(x) for x in (alpha, feats, steps)))
    for g, w, name in zip(got, want, ("weights", "features", "depth", "accum")):
        assert g.shape == np.shape(w), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **K3_TOL, err_msg=name)


def test_fused_composite_cpu_runs_plain_version():
    alpha, feats, steps = (torch.from_numpy(x) for x in _k3_inputs(R=20))
    with trace.recording():
        got = t_volumetric.fused_composite(alpha, feats, steps)
    assert trace.snapshot().total("launches/composite_fwd") == 0
    for g, w in zip(got, t_volumetric.composite_reference(alpha, feats, steps)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.fixture(scope="module")
def probe_inputs():
    """tools/probe_mosaic_gather.py's table [4096, 8] and 1,024 indices, from its keys."""
    import jax
    import jax.numpy as jnp

    T, N, F = 4096, 1024, 8
    table2d = jax.random.normal(jax.random.PRNGKey(0), (T, F), jnp.float32)
    idx = jax.random.randint(jax.random.PRNGKey(1), (N,), 0, T, jnp.int32)
    return np.array(table2d), np.array(idx)


def test_row_gather_plain_matches_probe(probe_inputs):
    table, idx = probe_inputs
    want = np.asarray(table)[idx]  # the probe's reference
    with trace.recording():
        got = t_gather.row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert trace.snapshot().total("launches/row_gather") == 0
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", [-1, 4096])
def test_row_gather_refuses_out_of_range_indices(probe_inputs, bad):
    table, idx = probe_inputs
    idx = idx.copy()
    idx[17] = bad
    with pytest.raises(IndexError):
        t_gather.row_gather(torch.from_numpy(table), torch.from_numpy(idx))


def test_row_gather_refuses_other_types(probe_inputs):
    table, idx = (torch.from_numpy(x) for x in probe_inputs)
    with pytest.raises(TypeError):
        t_gather.row_gather(table, idx.long())
    with pytest.raises(TypeError):
        t_gather.row_gather(table.double(), idx)
    with pytest.raises(ValueError):
        t_gather.row_gather(table.reshape(-1), idx)


@pytest.mark.cuda
@pytest.mark.parametrize("R,C", [(1, 32), (37, 40), (4096, 32)])
def test_fused_composite_kernel_matches_plain(cuda, R, C):
    """R = 37 leaves a partly empty last block; C = 40 needs two channel passes."""
    alpha, feats, steps = (torch.from_numpy(x).to(cuda) for x in _k3_inputs(R=R, S=33, C=C))
    with trace.recording():
        got = t_volumetric.fused_composite(alpha, feats, steps)
    assert trace.snapshot().total("launches/composite_fwd") == 1
    want = t_volumetric.composite_reference(alpha.double(), feats.double(), steps.double())
    for g, w in zip(got, want):
        torch.testing.assert_close(g.double(), w, **K3_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("T,F,N", [(4096, 8, 1024), (1000, 4, 1), (1000, 4, 37), (500, 3, 300), (70000, 5, 4099)])
def test_row_gather_kernel_matches_plain(cuda, T, F, N):
    """F = 4 and 8 take the 16-byte path, F = 3 and 5 the scalar one; N = 1, 37 and 4099 leave the
    last block partly empty."""
    gen = torch.Generator(device=cuda).manual_seed(T + N)
    table = torch.randn((T, F), generator=gen, device=cuda)
    idx = torch.randint(0, T, (N,), generator=gen, device=cuda, dtype=torch.int32)
    assert torch.equal(t_gather.row_gather(table, idx), t_gather.row_gather_reference(table, idx))


@pytest.mark.cuda
def test_row_gather_kernel_unaligned_table(cuda):
    """A table whose rows start 4 bytes past a 16-byte boundary takes the scalar path."""
    flat = torch.randn(1000 * 4 + 1, device=cuda)
    table = flat[1:].view(1000, 4)
    idx = torch.randint(0, 1000, (513,), device=cuda, dtype=torch.int32)
    assert t_gather.row_gather_path(table) == "scalar"
    assert torch.equal(t_gather.row_gather(table, idx), t_gather.row_gather_reference(table, idx))


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_do_not_run_k3_p1(cuda):
    alpha, feats, steps = (torch.from_numpy(x).to(cuda) for x in _k3_inputs(R=8))
    with pytest.raises(TypeError):
        t_volumetric.fused_composite(alpha.double(), feats.double(), steps.double())
    with pytest.raises(ValueError):
        t_volumetric.fused_composite(alpha, feats, steps[:, :-1].contiguous())
    table = torch.randn((10, 4), device=cuda)
    t_gather.check_indices(cuda)
    t_gather.row_gather(table, torch.tensor([0, 10], dtype=torch.int32, device=cuda))  # flagged on the card
    with pytest.raises(IndexError):
        t_gather.check_indices(cuda)
    with pytest.raises(ValueError):
        t_gather.row_gather(table, torch.tensor([0, 1], dtype=torch.int32))  # indices on the host


@pytest.mark.cuda
@pytest.mark.parametrize("F", [4, 3])
def test_row_gather_kernel_flags_out_of_range_indices(cuda, F):
    """On the card a bad index raises at check_indices, not at the launch; its output row is zeros
    and the rest of the gather is exact (F = 4 takes the 16-byte path, F = 3 the scalar one)."""
    table = torch.randn((1000, F), device=cuda)
    idx = torch.randint(0, 1000, (4099,), device=cuda, dtype=torch.int32)
    bad = torch.tensor([5, 700, 4098], device=cuda)
    idx[bad] = torch.tensor([-1, 1000, 2**31 - 1], dtype=torch.int32, device=cuda)
    t_gather.check_indices(cuda)
    got = t_gather.row_gather(table, idx)
    torch.cuda.synchronize()
    with pytest.raises(IndexError):
        t_gather.check_indices(cuda)
    t_gather.check_indices(cuda)  # the check cleared the flag
    want = t_gather.row_gather_reference(table, idx.clamp(0, 999))
    want[bad] = 0.0
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_row_gather_kernel_does_not_sync_the_host(cuda):
    table = torch.randn((2**16, 4), device=cuda)
    idx = torch.randint(0, 2**16, (2**16,), device=cuda, dtype=torch.int32)
    t_gather.row_gather(table, idx)  # builds and loads the library, makes the flag word
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = t_gather.row_gather(table, idx)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, t_gather.row_gather_reference(table, idx))
    t_gather.check_indices(cuda)


# ---------------------------------------------------------------------------- P1's paths
# csrc/gather.cu gives each thread ROWS_A_THREAD rows, THREADS apart, in blocks of THREADS threads
ROWS_A_THREAD, THREADS = 1, 128
PATHS = ("vec4", "scalar")


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("table_aligned", [True, False])
@pytest.mark.parametrize("F", [1, 2, 3, 4, 8, 12])
def test_row_gather_path_is_a_function_of_width_and_alignment(F, table_aligned, offset):
    """float4 rows where F is a multiple of 4 and the table 16-byte aligned (a fresh tensor is, a view
    one float in is not), floats otherwise; an idx view at an element offset of 1-3 changes no path.
    The plain version gives the same rows from such views."""
    table = torch.randn(1000 * F + 1)[(0 if table_aligned else 1) :][: 1000 * F].view(1000, F)
    idx = torch.randint(0, 1000, (300 + offset,), dtype=torch.int32)[offset:]
    assert t_gather.row_gather_path(table) == ("vec4" if F % 4 == 0 and table_aligned else "scalar")
    assert torch.equal(t_gather.row_gather(table, idx), table[idx.long()])


def test_p1_bounds_at_a_hash_grid_table():
    """[33554432, 4] x 4194304 at 3.35 TB/s: 36 bytes an index by what the gather needs, 52 by the
    32-byte sector a random 16-byte row costs; the ladder uses the probe's arithmetic."""
    from neuradar_tpu_torch.scripts import p1_ladder, probe_gather

    got = probe_gather.bounds_ms(4, 4194304)
    assert round(got["bound_ms"], 4) == 0.0451 and round(got["sector_bound_ms"], 4) == 0.0651
    assert p1_ladder.bounds_ms is probe_gather.bounds_ms
    assert (8 * 2**22, 4, 2**22) in p1_ladder.SHAPES and (6 * 2**20, 1, 2**22) in p1_ladder.SHAPES


@pytest.mark.parametrize("name", ["committed", "rows-2", "rows-4", "rows-8", "threads-256", "threads-512",
                                  "persistent", "contiguous-4", "contiguous-4-nc", "nc-no-allocate",
                                  "evict-last-table", "plain-stores"])
def test_p1_ladder_variants_patch_the_committed_source(name):
    """Each variant of the ladder is csrc/gather.cu with its lines replaced once each (committed: none)."""
    from neuradar_tpu_torch.scripts import p1_ladder

    text = p1_ladder.variant_source(name)
    assert (text == p1_ladder.SOURCE.read_text()) == (name == "committed")
    for _, new in p1_ladder.VARIANTS[name][1]:
        assert new in text


def _path_inputs(device, path, T, N, offset=0, seed=0):
    """A table and indices on ``device`` that take ``path`` (F = 4 or 3), idx a view ``offset`` in."""
    gen = torch.Generator(device=device).manual_seed(seed)
    F = 4 if path == "vec4" else 3
    table = torch.randn((T, F), generator=gen, device=device)
    idx = torch.randint(0, T, (N + offset,), generator=gen, device=device, dtype=torch.int32)[offset:]
    assert t_gather.row_gather_path(table) == path
    return table, idx


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 2, 3, 4, 8, 12])
@pytest.mark.parametrize("n", ["0", "1", "R-1", "R", "R+1", "block-1", "block+1", "wrap+1"])
def test_row_gather_kernel_edge_counts(cuda, F, n):
    """N = 0, 1, one short of a thread's rows, a thread's rows, one past, one short of and one past a
    block's rows, and one past the rows of as many blocks as a card holds at once: exact, and no
    launch for N = 0."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    block = THREADS * ROWS_A_THREAD
    N = {"0": 0, "1": 1, "R-1": ROWS_A_THREAD - 1, "R": ROWS_A_THREAD, "R+1": ROWS_A_THREAD + 1,
         "block-1": block - 1, "block+1": block + 1, "wrap+1": sms * 2048 * ROWS_A_THREAD + 1}[n]
    gen = torch.Generator(device=cuda).manual_seed(F * 100 + N)
    table = torch.randn((5000, F), generator=gen, device=cuda)
    idx = torch.randint(0, 5000, (N,), generator=gen, device=cuda, dtype=torch.int32)
    with trace.recording():
        got = t_gather.row_gather(table, idx)
    assert trace.snapshot().total("launches/row_gather") == (N > 0)
    assert got.shape == (N, F) and torch.equal(got, t_gather.row_gather_reference(table, idx))
    t_gather.check_indices(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("F", [4, 3])
def test_row_gather_kernel_unaligned_idx(cuda, F, offset):
    """An idx view at an element offset of 1-3 is gathered exactly, on the path of its table."""
    table = torch.randn((1000, F), device=cuda)
    idx = torch.randint(0, 1000, (4099 + offset,), device=cuda, dtype=torch.int32)[offset:]
    assert t_gather.row_gather_path(table) == ("vec4" if F == 4 else "scalar")
    assert torch.equal(t_gather.row_gather(table, idx), t_gather.row_gather_reference(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("path", PATHS)
def test_row_gather_kernel_flags_out_of_range_indices_on_each_path(cuda, path, offset):
    """On every path a bad index (among them the first of a block and the very last) sets the flag and
    gives a zero row; every other row is exact."""
    table, idx = _path_inputs(cuda, path, 1000, 4099, offset)
    bad = torch.tensor([0, THREADS, 700, 4098], device=cuda)
    idx[bad] = torch.tensor([-1, 1000, -(2**31), 2**31 - 1], dtype=torch.int32, device=cuda)
    t_gather.check_indices(cuda)
    got = t_gather.row_gather(table, idx)
    with pytest.raises(IndexError):
        t_gather.check_indices(cuda)
    want = t_gather.row_gather_reference(table, idx.clamp(0, 999))
    want[bad] = 0.0
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("path", PATHS)
def test_row_gather_kernel_two_launches_agree(cuda, path, offset):
    """Two launches on the same inputs give the same bits, and the plain version's."""
    table, idx = _path_inputs(cuda, path, 70000, 2**16 + 3, offset, seed=1)
    first = t_gather.row_gather(table, idx)
    assert torch.equal(t_gather.row_gather(table, idx), first)
    assert torch.equal(first, t_gather.row_gather_reference(table, idx))
    t_gather.check_indices(cuda)
