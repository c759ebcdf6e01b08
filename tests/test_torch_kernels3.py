"""Kernels K3 (fused_composite) and P1 (row_gather) of the port.

On the CPU the wrappers run their plain PyTorch versions, which are held here against the JAX
package: K3 against ``fused_composite`` in interpret mode and against the XLA formulation of
tests/test_pallas_ops.py, P1 against the reference of tools/probe_mosaic_gather.py
(``np.asarray(table2d)[idx]``) on the probe's own inputs. The tests marked ``cuda`` hold each CUDA
kernel against its plain version on the card at ragged sizes and skip without one; JAX is imported
inside the fixtures only, so they also run where JAX is absent:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels3.py
"""

import numpy as np
import pytest
import torch

from neuradar_tpu_torch.ops import gather as t_gather
from neuradar_tpu_torch.ops import volumetric as t_volumetric

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
    before = t_volumetric.fused_composite.launches
    got = t_volumetric.fused_composite(alpha, feats, steps)
    assert t_volumetric.fused_composite.launches == before
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
    before = t_gather.row_gather.launches
    got = t_gather.row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert t_gather.row_gather.launches == before
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
    before = t_volumetric.fused_composite.launches
    got = t_volumetric.fused_composite(alpha, feats, steps)
    assert t_volumetric.fused_composite.launches == before + 1
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
    assert torch.equal(t_gather.row_gather(table, idx), t_gather.row_gather_reference(table, idx))


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_do_not_run_k3_p1(cuda):
    alpha, feats, steps = (torch.from_numpy(x).to(cuda) for x in _k3_inputs(R=8))
    with pytest.raises(TypeError):
        t_volumetric.fused_composite(alpha.double(), feats.double(), steps.double())
    with pytest.raises(ValueError):
        t_volumetric.fused_composite(alpha, feats, steps[:, :-1].contiguous())
    table = torch.randn((10, 4), device=cuda)
    with pytest.raises(IndexError):
        t_gather.row_gather(table, torch.tensor([0, 10], dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        t_gather.row_gather(table, torch.tensor([0, 1], dtype=torch.int32))  # indices on the host
