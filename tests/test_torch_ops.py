"""Kernels K1 (composite_sky_fwd) and K2 (self_attention_fwd) of the port.

On the CPU the wrappers run their plain PyTorch versions, which are held here
against the JAX package: K1 against fused_composite_sky in interpret mode and
against the model's XLA formulation, K2 against reference_attention and
fused_self_attention in interpret mode. The tests marked ``cuda`` hold each
CUDA kernel against its plain version on the card and skip without one.

JAX is imported inside the fixtures only, so the ``cuda`` tests also run on a
machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ops.py
"""

import numpy as np
import pytest
import torch

from neuradar_tpu_torch.ops import attention as t_attention
from neuradar_tpu_torch.ops import volumetric as t_volumetric

K1_TOL = dict(rtol=1e-5, atol=1e-6)
K2_TOL = dict(rtol=1e-4, atol=1e-5)  # the fused kernels sum the softmax in another order


def _k1_inputs(R=300, S=33, C=32, seed=0):
    rng = np.random.RandomState(seed)
    return rng.uniform(0.0, 0.95, (R, S)).astype(np.float32), rng.normal(size=(R, S, C)).astype(np.float32)


def _k2_inputs(B=2, S=300, D=48, seed=1):
    rng = np.random.RandomState(seed)
    return tuple(rng.normal(size=(B, S, D)).astype(np.float32) for _ in range(3))


@pytest.fixture(scope="module")
def jax_volumetric():
    import jax.numpy as jnp

    from neuradar_tpu.cameras.rays import render_weights_from_alpha
    from neuradar_tpu.ops.volumetric import fused_composite_sky

    def xla_composite_sky(alpha, feats):
        """models/neuradar._nff_core's non-Pallas branch."""
        w = render_weights_from_alpha(alpha)
        accum = jnp.sum(w, axis=-1, keepdims=True)
        w_sky = jnp.concatenate([w[..., :-1], w[..., -1:] + 1 - accum], axis=-1)
        return w_sky, jnp.sum(w_sky[..., None] * feats, axis=-2), accum

    return fused_composite_sky, xla_composite_sky


@pytest.fixture(scope="module")
def jax_attention():
    from neuradar_tpu.ops.attention import fused_self_attention, reference_attention

    return fused_self_attention, reference_attention


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("which", ["pallas_interpret", "xla"])
def test_composite_sky_plain_matches_jax(jax_volumetric, which):
    fused, xla = jax_volumetric
    alpha, feats = _k1_inputs()
    want = fused(alpha, feats, True) if which == "pallas_interpret" else xla(alpha, feats)
    got = t_volumetric.composite_sky_fwd(torch.from_numpy(alpha), torch.from_numpy(feats))
    for g, w, name in zip(got, want, ("w_sky", "features", "accum")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **K1_TOL, err_msg=name)


def test_composite_sky_cpu_runs_plain_version():
    alpha, feats = (torch.from_numpy(x) for x in _k1_inputs(R=64))
    before = t_volumetric.composite_sky_fwd.launches
    got = t_volumetric.composite_sky_fwd(alpha, feats)
    want = t_volumetric.composite_sky_reference(alpha, feats)
    assert t_volumetric.composite_sky_fwd.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("which", ["pallas_interpret", "reference"])
def test_attention_plain_matches_jax(jax_attention, which):
    """S = 300 is not a multiple of 128: the Pallas kernel pads and masks the key tail."""
    fused, reference = jax_attention
    q, k, v = _k2_inputs()
    want = fused(q, k, v, 0, 0.0, None, True) if which == "pallas_interpret" else reference(q, k, v)
    got = t_attention.self_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **K2_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 37, 4096])
def test_composite_sky_kernel_matches_plain(cuda, R):
    """R = 37 leaves a partly empty last block; C = 40 needs two channel passes."""
    alpha, feats = (torch.from_numpy(x).to(cuda) for x in _k1_inputs(R=R, C=40 if R == 37 else 32))
    got = t_volumetric.composite_sky_fwd(alpha, feats)
    want = t_volumetric.composite_sky_reference(alpha, feats)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **K1_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D", [(2, 300, 48), (1, 3531, 48), (3, 5, 32), (1, 64, 16)])
def test_attention_kernel_matches_plain(cuda, B, S, D):
    q, k, v = (torch.from_numpy(x).to(cuda) for x in _k2_inputs(B, S, D))
    torch.testing.assert_close(t_attention.self_attention_fwd(q, k, v), t_attention.attention_reference(q, k, v),
                               **K2_TOL)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_do_not_run(cuda):
    q, k, v = (torch.from_numpy(x).to(cuda) for x in _k2_inputs())
    with pytest.raises(NotImplementedError):
        t_attention.self_attention_fwd(q, k, v, dropout_rate=0.1)
    with pytest.raises(TypeError):
        t_attention.self_attention_fwd(q.half(), k.half(), v.half())
    alpha, feats = (torch.from_numpy(x).to(cuda) for x in _k1_inputs(R=8))
    with pytest.raises(TypeError):
        t_volumetric.composite_sky_fwd(alpha.double(), feats.double())
    with pytest.raises(ValueError):
        t_volumetric.composite_sky_fwd(alpha, feats.transpose(1, 2).contiguous().transpose(1, 2))
