"""Kernels K1 (composite_sky_fwd / _bwd) and K2 (self_attention_fwd / _bwd) of the port.

On the CPU the wrappers run their plain PyTorch versions, which are held here
against the JAX package: K1 against fused_composite_sky in interpret mode and
against the model's XLA formulation, forward and VJP; K2 against
reference_attention and fused_self_attention in interpret mode, forward and
VJP at dropout 0. With dropout the plain version is tested on its own
(gradcheck, determinism per seed, seed sensitivity, keep fraction,
unbiasedness), as the TPU kernel's own tests do: the two hash different bits.
The tests marked ``cuda`` hold each CUDA kernel against its plain version on
the card and skip without one.

JAX is imported inside the fixtures only, so the ``cuda`` tests also run on a
machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ops.py
"""

import numpy as np
import pytest
import torch

from neuradar_tpu_torch.ops import attention as t_attention
from neuradar_tpu_torch.ops import volumetric as t_volumetric
from neuradar_tpu_torch.utils import trace

K1_TOL = dict(rtol=1e-5, atol=1e-6)
K2_TOL = dict(rtol=1e-4, atol=1e-5)  # the fused kernels sum the softmax in another order
# backward: the TPU kernel's suffix sum is total - cumsum, which cancels to an absolute error of a few
# ulp of the largest suffix (|dalpha| reaches ~10 here); the plain version's is torch's cumprod VJP,
# the CUDA kernel's a reverse running sum; all float32
K1_BWD_TOL = dict(rtol=1e-4, atol=1e-4)
K2_BWD_TOL = dict(rtol=2e-4, atol=2e-5)  # dS sums S products per entry, in three different orders


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
    with trace.recording():
        got = t_volumetric.composite_sky_fwd(alpha, feats)
    want = t_volumetric.composite_sky_reference(alpha, feats)
    assert trace.snapshot().total("launches/composite_sky_fwd") == 0
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


def _k1_cotangents(R, S, C, seed=2):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(R, S)).astype(np.float32), rng.normal(size=(R, C)).astype(np.float32),
            rng.normal(size=(R, 1)).astype(np.float32))


# (which, S, C): the train shape's S = 33 and C = 32, then one sample (the sky sample alone), more
# samples than the CUDA kernel's float4 path takes, and a C that is no power of two
K1_BWD_JAX_CASES = [pytest.param(which, S, C, id=which + suffix) for S, C, suffix in
                    ((33, 32, ""), (1, 32, "-S1"), (65, 32, "-S65"), (33, 40, "-C40"))
                    for which in ("pallas_interpret", "xla")]


@pytest.mark.parametrize("which,S,C", K1_BWD_JAX_CASES)
def test_composite_sky_bwd_plain_matches_jax(jax_volumetric, which, S, C):
    """jax.vjp of fused_composite_sky in interpret mode reaches _sky_pallas_bwd; daccum is nonzero."""
    import jax

    fused, xla = jax_volumetric
    alpha, feats = _k1_inputs(R=200, S=S, C=C)
    cots = _k1_cotangents(*feats.shape)
    fn = (lambda a, f: fused(a, f, True)) if which == "pallas_interpret" else xla
    _, vjp = jax.vjp(fn, alpha, feats)
    want = vjp(tuple(cots))
    got = t_volumetric.composite_sky_bwd(*(torch.from_numpy(x) for x in (alpha, feats, *cots)))
    for g, w, name in zip(got, want, ("dalpha", "dfeats")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **K1_BWD_TOL, err_msg=name)


def test_composite_sky_function_backward():
    """The autograd Function routes to composite_sky_bwd; a missing output gradient counts as zero."""
    alpha, feats = (torch.from_numpy(x).requires_grad_(True) for x in _k1_inputs(R=50))
    dwsky, df, _ = (torch.from_numpy(x) for x in _k1_cotangents(50, 33, 32))
    w_sky, features, _accum = t_volumetric.composite_sky(alpha, feats)
    torch.autograd.backward((w_sky, features), (dwsky, df))
    want = t_volumetric.composite_sky_bwd(alpha.detach(), feats.detach(), dwsky, df, torch.zeros(50, 1))
    torch.testing.assert_close(alpha.grad, want[0], rtol=0, atol=0)
    torch.testing.assert_close(feats.grad, want[1], rtol=0, atol=0)


def test_attention_bwd_plain_matches_jax(jax_attention):
    """jax.vjp of fused_self_attention in interpret mode reaches _bwd_call; S = 300 pads to 384 there."""
    import jax

    fused, _ = jax_attention
    q, k, v = _k2_inputs()
    dout = np.random.RandomState(5).normal(size=q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: fused(a, b, c, 0, 0.0, None, True), q, k, v)
    want = vjp(dout)
    got = t_attention.self_attention_bwd(*(torch.from_numpy(x) for x in (q, k, v)), None,
                                         torch.from_numpy(dout), None)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **K2_BWD_TOL, err_msg=name)


def test_attention_dropout_gradcheck():
    """Float64 gradcheck of the plain version through the keep mask (the mask is fixed by the seed);
    fast mode checks the Jacobian along random directions."""
    rng = np.random.RandomState(6)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 7, 16))).requires_grad_(True) for _ in range(3))
    assert torch.autograd.gradcheck(lambda a, b, c: t_attention.self_attention(a, b, c, 11, 0.3), (q, k, v),
                                    fast_mode=True)


def test_attention_dropout_mask_properties():
    """Deterministic per seed, different across seeds, keep fraction within 3 sigma of 1 - rate,
    and a pure function of (seed, b, q, k): a smaller problem is a corner of a larger one."""
    rate, B, S = 0.1, 2, 300
    m7 = t_attention.keep_mask(7, B, S, rate)
    assert torch.equal(m7, t_attention.keep_mask(7, B, S, rate))
    assert not torch.equal(m7, t_attention.keep_mask(8, B, S, rate))
    assert not torch.equal(m7[0], m7[1]), "each scan draws its own mask"
    n = m7.numel()
    assert abs(m7.float().mean().item() - (1 - rate)) < 3 * (rate * (1 - rate) / n) ** 0.5
    assert torch.equal(t_attention.keep_mask(7, 1, 100, rate)[0], m7[0, :100, :100])


def test_attention_dropout_unbiased():
    """Averaged over seeds, dropout leaves the output unchanged (inverted scaling 1 / (1 - rate))."""
    q, k, v = (torch.from_numpy(x) for x in _k2_inputs(B=1, S=64, D=16))
    want = t_attention.attention_reference(q, k, v)
    mean = torch.stack([t_attention.self_attention_fwd(q, k, v, 0.2, seed) for seed in range(200)]).mean(0)
    assert (mean - want).abs().mean() < 0.1 * want.abs().mean()
    assert not torch.allclose(t_attention.self_attention_fwd(q, k, v, 0.2, 1), want)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 37, 4096])
def test_composite_sky_kernel_matches_plain(cuda, R):
    """R = 37 leaves a partly empty last block; C = 40 needs two channel passes."""
    alpha, feats = (torch.from_numpy(x).to(cuda) for x in _k1_inputs(R=R, C=40 if R == 37 else 32))
    got = t_volumetric.composite_sky_fwd(alpha, feats)
    want = t_volumetric.composite_sky_reference(alpha, feats)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **K1_TOL)


# K2 on the card: sequence lengths around the kernels' 64-row tiles (S = 3,531 = 55 * 64 + 11 is the
# radar scan), every head width they are built for, and the train batch of 16 scans at S = 3,531
K2_LENGTHS = (1, 5, 63, 64, 65, 127, 300, 3531)
K2_WIDTHS = (16, 32, 48, 64)


def _k2_batch(S):
    return 16 if S == 3531 else 2


@pytest.mark.cuda
@pytest.mark.parametrize("D", K2_WIDTHS)
@pytest.mark.parametrize("S", K2_LENGTHS)
def test_attention_kernel_matches_plain(cuda, S, D):
    q, k, v = (torch.from_numpy(x).to(cuda) for x in _k2_inputs(_k2_batch(S), S, D))
    torch.testing.assert_close(t_attention.self_attention_fwd(q, k, v), t_attention.attention_reference(q, k, v),
                               **K2_TOL)


# K1 backward on the card: S = 1, 2 and the ragged halves around 32 and 64 take the float4 path
# (with C = 32, 40 and 64), S = 65 and 768 and C = 1 the general one; R = 37 leaves the last block
# of 8 rays partly empty
K1_BWD_RAYS = (1, 37, 4096)
K1_BWD_SAMPLES = (1, 2, 31, 32, 33, 64, 65, 768)
K1_BWD_CHANNELS = (1, 32, 40, 64)


def _k1_bwd_card_inputs(cuda, R, S, C):
    alpha, feats = (torch.from_numpy(x).to(cuda) for x in _k1_inputs(R=R, S=S, C=C))
    return (alpha, feats, *(torch.from_numpy(x).to(cuda) for x in _k1_cotangents(R, S, C)))


@pytest.mark.cuda
@pytest.mark.parametrize("C", K1_BWD_CHANNELS)
@pytest.mark.parametrize("S", K1_BWD_SAMPLES)
@pytest.mark.parametrize("R", K1_BWD_RAYS)
def test_composite_sky_bwd_kernel_matches_plain(cuda, R, S, C):
    inputs = _k1_bwd_card_inputs(cuda, R, S, C)
    path = t_volumetric.composite_sky_bwd_path(inputs[1], inputs[3])
    assert path == ("float4" if S <= 64 and C % 4 == 0 else "general")
    with trace.recording():
        got = t_volumetric.composite_sky_bwd(*inputs)
    snap = trace.snapshot()
    float4 = path == "float4"
    assert (snap.total("launches/composite_sky_bwd"), snap.total("launches/composite_sky_bwd_general")) == (
        float4, not float4)
    want = t_volumetric.composite_sky_bwd_reference(*inputs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **K1_BWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("R,S,C", [(113840, 33, 32), (4096, 65, 40)])
def test_composite_sky_bwd_kernel_is_deterministic(cuda, R, S, C):
    """No atomics, on either path: two launches on the same inputs agree bit for bit."""
    inputs = _k1_bwd_card_inputs(cuda, R, S, C)
    first, second = t_volumetric.composite_sky_bwd(*inputs), t_volumetric.composite_sky_bwd(*inputs)
    for a, b, name in zip(first, second, ("dalpha", "dfeats")):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_composite_sky_bwd_unaligned_rows_take_the_general_path(cuda):
    """feats 4 bytes past a 16-byte boundary: the float4 path cannot load its rows."""
    alpha, feats, *cots = _k1_bwd_card_inputs(cuda, 37, 33, 32)
    flat = torch.empty(feats.numel() + 1, device=cuda)
    flat[1:] = feats.reshape(-1)
    shifted = flat[1:].view(feats.shape)
    assert shifted.is_contiguous() and t_volumetric.composite_sky_bwd_path(shifted, cots[1]) == "general"
    got = t_volumetric.composite_sky_bwd(alpha, shifted, *cots)
    for g, w in zip(got, t_volumetric.composite_sky_bwd_reference(alpha, feats, *cots)):
        torch.testing.assert_close(g, w, **K1_BWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D", K2_WIDTHS)
@pytest.mark.parametrize("S", K2_LENGTHS)
def test_attention_train_kernels_match_plain(cuda, S, D, rate):
    """Forward with dropout (same seed, same mask as the plain version), its lse, and the backward."""
    B = _k2_batch(S)
    q, k, v = (torch.from_numpy(x).to(cuda) for x in _k2_inputs(B, S, D))
    dout = torch.from_numpy(np.random.RandomState(5).normal(size=(B, S, D)).astype(np.float32)).to(cuda)
    out, lse = t_attention.self_attention_fwd(q, k, v, rate, 123, return_lse=True)
    torch.testing.assert_close(out, t_attention.attention_reference(q, k, v, 123, rate), **K2_TOL)
    s = torch.einsum("bqd,bkd->bqk", q * D**-0.5, k)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), **K2_TOL)
    got = t_attention.self_attention_bwd(q, k, v, out, dout, lse, rate, 123)
    want = t_attention.attention_bwd_reference(q, k, v, dout, 123, rate)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **K2_BWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(2, 300), (16, 3531)])
def test_attention_kernels_are_deterministic(cuda, B, S):
    """No atomics: two launches of the forward and the backward on the same inputs agree bit for bit."""
    q, k, v, dout = (torch.from_numpy(x).to(cuda) for x in (*_k2_inputs(B, S, 48), _k2_inputs(B, S, 48, seed=5)[0]))
    runs = []
    for _ in range(2):
        out, lse = t_attention.self_attention_fwd(q, k, v, 0.1, 77, return_lse=True)
        runs.append((out, lse, *t_attention.self_attention_bwd(q, k, v, out, dout, lse, 0.1, 77)))
    for a, b, name in zip(*runs, ("out", "lse", "dq", "dk", "dv")):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_autograd_functions_on_card_match_cpu(cuda):
    alpha, feats = _k1_inputs(R=300)
    cots = _k1_cotangents(300, 33, 32)
    grads = []
    for dev in ("cpu", cuda):
        a, f = (torch.from_numpy(x).to(dev).requires_grad_(True) for x in (alpha, feats))
        torch.autograd.backward(t_volumetric.composite_sky(a, f), [torch.from_numpy(c).to(dev) for c in cots])
        grads.append((a.grad.cpu(), f.grad.cpu()))
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, **K1_BWD_TOL)
    qkv = _k2_inputs(B=2, S=200, D=48)
    grads = []
    for dev in ("cpu", cuda):
        q, k, v = (torch.from_numpy(x).to(dev).requires_grad_(True) for x in qkv)
        t_attention.self_attention(q, k, v, 5, 0.1).square().sum().backward()
        grads.append([t.grad.cpu() for t in (q, k, v)])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, **K2_BWD_TOL)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_do_not_run(cuda):
    q, k, v = (torch.from_numpy(x).to(cuda) for x in _k2_inputs())
    with pytest.raises(ValueError):
        t_attention.self_attention_fwd(q, k, v, dropout_rate=1.0)
    with pytest.raises(TypeError):
        t_attention.self_attention_fwd(q.half(), k.half(), v.half())
    alpha, feats = (torch.from_numpy(x).to(cuda) for x in _k1_inputs(R=8))
    with pytest.raises(TypeError):
        t_volumetric.composite_sky_fwd(alpha.double(), feats.double())
    with pytest.raises(ValueError):
        t_volumetric.composite_sky_fwd(alpha, feats.transpose(1, 2).contiguous().transpose(1, 2))
