"""The port's camera optimizer and exponential maps against the JAX package's.

exp_map_SO3xR3 / exp_map_SE3 and skew_symmetric at random tangents, at small ones (the Taylor
branch) and at exactly zero, values and vector-Jacobian products; ``_safe_norm``'s gradient at 0;
and ``CameraOptimizer`` in every mode, its parameters carried from flax by ``load_jax_params``:
the corrected ray bundle, the regularizer with a scalar and a per-axis translation penalty and its
gradient (at the zero start too), and the metrics. Inputs are made with numpy from a seed; float32
on both sides. Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuradar_tpu.cameras import camera_optimizers as jco
from neuradar_tpu.cameras.rays import RayBundle as JRayBundle
from neuradar_tpu.utils import poses as jp
from neuradar_tpu_torch.cameras import camera_optimizers as tco
from neuradar_tpu_torch.cameras.rays import RayBundle as TRayBundle
from neuradar_tpu_torch.utils import poses as tp
from neuradar_tpu_torch.utils.params import load_jax_params

TOL = dict(rtol=1e-5, atol=1e-6)
MODES = {
    "SO3xR3": jco.CameraOptimizerConfig(mode="SO3xR3"),
    "SE3": jco.CameraOptimizerConfig(mode="SE3"),
    "scaled": jco.ScaledCameraOptimizerConfig(),
}
T_MODES = {
    "SO3xR3": tco.CameraOptimizerConfig(mode="SO3xR3"),
    "SE3": tco.CameraOptimizerConfig(mode="SE3"),
    "scaled": tco.ScaledCameraOptimizerConfig(),
}


def _tangents(kind, n=64, seed=0):
    rng = np.random.RandomState(seed)
    t = rng.normal(size=(n, 6)).astype(np.float32)
    if kind == "small":  # squared angles under 1e-8: the Taylor branch
        t[:, 3:] *= 1e-5
    elif kind == "zero":
        t[:] = 0.0
    elif kind == "mixed":  # large, small and zero rotations in one batch
        t[::3, 3:] *= 1e-5
        t[1::3, 3:] = 0.0
    return t


@pytest.mark.parametrize("kind", ["random", "small", "zero", "mixed"])
@pytest.mark.parametrize("name", ["exp_map_SO3xR3", "exp_map_SE3"])
def test_exp_maps(name, kind):
    """Values, and the VJP with a random cotangent, against jax.vjp; finite at a zero tangent.
    Tolerance rtol 1e-5 / atol 1e-6 on values and 1e-4 on gradients (sin, cos and their quotients
    round their last ulp on each side)."""
    t = _tangents(kind)
    cot = np.random.RandomState(1).normal(size=(64, 3, 4)).astype(np.float32)
    want, vjp = jax.vjp(getattr(jp, name), jnp.asarray(t))
    (want_g,) = vjp(jnp.asarray(cot))
    tt = torch.from_numpy(t).requires_grad_(True)
    got = getattr(tp, name)(tt)
    (got_g,) = torch.autograd.grad(got, tt, torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert np.isfinite(got_g.numpy()).all()
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-4)


def test_skew_symmetric():
    v = np.random.RandomState(2).normal(size=(5, 3)).astype(np.float32)
    got = tp.skew_symmetric(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jp.skew_symmetric(jnp.asarray(v))))
    np.testing.assert_allclose(got @ v[..., None], 0.0, atol=1e-6)  # v x v = 0


def test_safe_norm_gradient_is_zero_at_zero():
    """The norm's gradient at exactly 0 is 0 (jnp.linalg.norm's is NaN there); elsewhere it is the
    norm's own."""
    x = torch.zeros((3, 3), requires_grad=True)
    (g,) = torch.autograd.grad(tco._safe_norm(x).sum(), x)
    assert torch.equal(g, torch.zeros_like(g))
    y = torch.tensor([[3.0, 4.0, 0.0], [0.0, 0.0, 0.0]], requires_grad=True)
    (g,) = torch.autograd.grad(tco._safe_norm(y).sum(), y)
    torch.testing.assert_close(g, torch.tensor([[0.6, 0.8, 0.0], [0.0, 0.0, 0.0]]))
    assert np.isnan(np.asarray(jax.grad(lambda v: jnp.linalg.norm(v))(jnp.zeros(3)))).all()


def _pair(mode, adj):
    """The JAX module with ``adj`` as its pose_adjustment, and the port's module loaded from the
    same flax tree by load_jax_params."""
    jmod = jco.CameraOptimizer(config=MODES[mode], num_cameras=adj.shape[0])
    params = jmod.init(jax.random.PRNGKey(0), jnp.zeros((2,), jnp.int32))["params"]
    assert params["pose_adjustment"].shape == adj.shape and not np.asarray(params["pose_adjustment"]).any()
    params = {"pose_adjustment": jnp.asarray(adj)}
    tmod = tco.CameraOptimizer(T_MODES[mode], adj.shape[0])
    assert not tmod.pose_adjustment.detach().any()  # zeros at the start, as flax's init
    load_jax_params(tmod, params)
    return jmod, params, tmod


def _bundles(n=96, n_frames=12, seed=3):
    rng = np.random.RandomState(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 10
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    idx = rng.randint(0, n_frames, (n, 1)).astype(np.int32)
    pa = np.ones((n, 1), np.float32)
    return (JRayBundle(origins=jnp.asarray(o), directions=jnp.asarray(d), pixel_area=jnp.asarray(pa),
                       camera_indices=jnp.asarray(idx)),
            TRayBundle(origins=torch.from_numpy(o), directions=torch.from_numpy(d), pixel_area=torch.from_numpy(pa),
                       camera_indices=torch.from_numpy(idx)))


@pytest.mark.parametrize("start", ["random", "zero", "mixed"])
@pytest.mark.parametrize("mode", list(MODES))
def test_camera_optimizer(mode, start):
    """apply_to_raybundle, regularization_loss and its gradient in pose_adjustment, and the metrics,
    with parameters carried by load_jax_params; at the zero start every gradient is finite.
    Tolerance rtol 1e-5 / atol 1e-6 on the rays and the loss, 1e-5 on the gradients."""
    adj = _tangents(start, n=12, seed=4) * 0.1
    jmod, params, tmod = _pair(mode, adj)
    jb, tb = _bundles()
    want = jmod.apply({"params": params}, jb, method=jco.CameraOptimizer.apply_to_raybundle)
    got = tmod.apply_to_raybundle(tb)
    np.testing.assert_allclose(got.origins.detach().numpy(), np.asarray(want.origins), **TOL)
    np.testing.assert_allclose(got.directions.detach().numpy(), np.asarray(want.directions), **TOL)
    assert got.pixel_area is tb.pixel_area and got.camera_indices is tb.camera_indices

    def j_loss(p):
        return jmod.apply({"params": p}, method=jco.CameraOptimizer.regularization_loss)

    want_l, want_g = jax.value_and_grad(j_loss)(params)
    got_l = tmod.regularization_loss()
    (got_g,) = torch.autograd.grad(got_l, tmod.pose_adjustment)
    np.testing.assert_allclose(float(got_l.detach()), float(want_l), **TOL)
    assert np.isfinite(got_g.numpy()).all()
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g["pose_adjustment"]), rtol=1e-5, atol=1e-5)

    # the gradient through the corrected rays, at the zero start too
    cot_o, cot_d = (np.random.RandomState(s).normal(size=(96, 3)).astype(np.float32) for s in (5, 6))

    def j_rays(p):
        rb = jmod.apply({"params": p}, jb, method=jco.CameraOptimizer.apply_to_raybundle)
        return jnp.sum(rb.origins * cot_o) + jnp.sum(rb.directions * cot_d)

    want_rg = jax.grad(j_rays)(params)["pose_adjustment"]
    rb = tmod.apply_to_raybundle(tb)
    (got_rg,) = torch.autograd.grad((rb.origins * torch.from_numpy(cot_o)).sum()
                                    + (rb.directions * torch.from_numpy(cot_d)).sum(), tmod.pose_adjustment)
    assert np.isfinite(got_rg.numpy()).all()
    np.testing.assert_allclose(got_rg.numpy(), np.asarray(want_rg), rtol=1e-4, atol=1e-4)

    want_m = jmod.apply({"params": params}, method=jco.CameraOptimizer.metrics)
    got_m = tmod.metrics()
    assert sorted(got_m) == sorted(want_m)
    for key in want_m:
        np.testing.assert_allclose(float(got_m[key]), float(want_m[key]), **TOL)


def test_off_mode():
    """Off: no parameter, the bundle passes through, no metrics; an unknown mode is refused."""
    tmod = tco.CameraOptimizer(tco.CameraOptimizerConfig(), 4)
    assert not list(tmod.parameters())
    _, tb = _bundles()
    assert tmod.apply_to_raybundle(tb) is tb and tmod.metrics() == {}
    torch.testing.assert_close(tmod(torch.arange(3)), torch.eye(3, 4).expand(3, 3, 4))
    with pytest.raises(ValueError, match="SO3xR3"):
        tco.CameraOptimizer(tco.CameraOptimizerConfig(mode="SE2"), 4)
