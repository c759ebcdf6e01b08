"""The set-based radar decoder of the port (neuradar_tpu_torch) against the JAX package, with the
radar-loss options that come with it: the euclidean multi-Bernoulli loss, DETR's set loss and the
host's Hungarian assignment.

Module by module (flax MultiHeadDotProductAttention against the port's MultiHeadAttention, the DETR
decoder layer, SetRadarDecoder with and without deep supervision, the losses under both
assignments, the euclidean sampler, the optimizer groups) and then the tiny train step of the set
model on the scene and batch of tests/test_torch_train.py, with the multi-Bernoulli and the DETR
loss, in float32 and in bf16: every loss term, radar_aux_loss included, and every gradient against
jax.value_and_grad of the JAX pipeline's train loss (in tests/test_torch_set_decoder_train.py, which
takes this file's fixtures and helpers); and the set model's eval radar metrics. Both
sides get the same perturbed weights (load_jax_params) and the same draws: flips and dropout off,
one jitter list handed out to both samplers. The bf16 step pins the radar association to one
assignment on both sides, since bf16 rounding flips the auction's near ties (as
tests/test_torch_bf16_train.py pins it). Dropout is tested on the port alone, its structure and
keep rate, since the two packages draw from different generators. Each test states its tolerance,
taken from the rules of tests/test_torch_train.py (float32) and tests/test_torch_bf16_train.py
(bf16).

JAX is imported inside the fixtures only, so the tests marked ``cuda`` (the set model's forward and
train step on the card against the CPU, with K2 launched) also run on a machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_set_decoder.py
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from neuradar_tpu_torch.data import datamanager as t_dm
from neuradar_tpu_torch.data.dataparsers import synthetic as t_synthetic
from neuradar_tpu_torch.engine import optimizers as t_opt
from neuradar_tpu_torch.model_components import radar_decoder as t_rd
from neuradar_tpu_torch.model_components import radar_utils as t_ru
from neuradar_tpu_torch.ops import attention as t_attention
from neuradar_tpu_torch.pipelines import ad_neuradar_pipeline as t_pipeline
from neuradar_tpu_torch.scripts import validate_learning
from neuradar_tpu_torch.utils import rng as t_rng
from neuradar_tpu_torch.utils import trace
from neuradar_tpu_torch.utils.params import init_params, load_jax_params

# the tiny scene, batch and model of tests/test_torch_slice.py and tests/test_torch_train.py
SCENE = dict(num_frames=8, image_height=24, image_width=36, lidar_points_per_scan=256)
RADAR_FOV = dict(min_azimuth=-0.8, max_azimuth=0.8, min_elevation=-0.08, max_elevation=0.32,
                 azimuth_step=0.1, elevation_step=0.1)
DM = dict(num_rgb_patches=2, patch_size=4, num_lidar_rays=32, num_radar_scans=2, max_radar_gt=16)
QUERIES = 24  # more than the batch's 16 GT rows, as num_radar_queries 300 is more than max_radar_gt 256
# float32, as tests/test_torch_train.py: values to summation order and the last ulp of exp/log
TOL = dict(rtol=1e-5, atol=1e-6)
# bf16 modules: the jitted JAX module fuses its bf16 ops and rounds other intermediates than the port
# does, so the two bf16 results carry rounding errors of the same size in other places (measured: the
# port's distance to JAX up to 1.07 times JAX's own distance to float32). Each output and gradient is
# held by its accuracy: the port's bf16 result no farther from the JAX module's float32 result than
# BF16_ACCURACY times JAX's bf16 result is, in L2 over the tensor (measured: 1.10 at most)
BF16_ACCURACY = 1.25
# a bf16 train step, as tests/test_torch_bf16_train.py: |port - JAX| within GRAD_SHARE of
# |port bf16 - port float32| in L2 over a parameter
GRAD_SHARE = 0.25


@pytest.fixture(scope="module")
def J():
    """The JAX side: jax, flax and the JAX package's modules."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from neuradar_tpu.model_components import radar_decoder, radar_utils
    from tests.test_torch_slice import perturb

    return SimpleNamespace(jax=jax, jnp=jnp, nn=nn, rd=radar_decoder, ru=radar_utils,
                           perturb=lambda params: perturb(params, {})[0])


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol=TOL, name=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=name, **tol)


def _bf16_accuracy(got, want, want_f32, names, what):
    """Each bf16 tensor of the port against JAX's by BF16_ACCURACY: |port - f32| over |JAX - f32|."""
    ratios = {name: float(np.linalg.norm(_np(g) - _np(f)) / np.linalg.norm(_np(w) - _np(f)))
              for g, w, f, name in zip(got, want, want_f32, names)}
    print(f"{what} in bf16: |port - float32| over |JAX - float32| {ratios}")
    assert all(r <= BF16_ACCURACY for r in ratios.values()), ratios


def _jax_vjp(J, fn, inputs, cot):
    """fn(*inputs) and its VJP for the cotangent ``cot`` (an array, or a tuple for a tuple output, cast
    to the output's dtype), in one jit (tracing once beats eager dispatch of every small op)."""

    def both(*xs):
        out, vjp = J.jax.vjp(fn, *xs)
        cts = (J.jax.tree.map(lambda c, o: J.jnp.asarray(c, o.dtype), cot, out))
        return out, vjp(cts)

    return J.jax.jit(both)(*(J.jnp.asarray(x) for x in inputs))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


# ---------------------------------------------------------------------------- attention and decoder


def _attention_inputs(seed=3, B=2, Lq=12, Lk=30, d=48):
    rng = np.random.RandomState(seed)
    return [rng.normal(size=(B, L, d)).astype(np.float32) for L in (Lq, Lk, Lk, Lq)]


@pytest.mark.parametrize("dtype,heads", [("float32", 1), ("float32", 2), ("bfloat16", 1)])
def test_multi_head_attention_matches_flax(J, dtype, heads):
    """MultiHeadAttention against flax MultiHeadDotProductAttention (deterministic), output and the
    gradients of the three inputs. float32: rtol 1e-5, atol 1e-6 on the output; rtol 1e-4, atol 1e-5
    of the largest entry on the gradients (softmax backward sums in another order). bf16 (inputs,
    projections, scores and softmax in bf16): the output and the gradients by BF16_ACCURACY against
    the flax module in float32 (measured: 1.05 at most)."""
    q, k, v, cot = _attention_inputs()
    bf16 = dtype == "bfloat16"
    jdt = J.jnp.bfloat16 if bf16 else J.jnp.float32
    jmod = J.nn.MultiHeadDotProductAttention(num_heads=heads, qkv_features=48, dtype=jdt if bf16 else None)
    params = J.perturb(jmod.init(J.jax.random.PRNGKey(0), q, k, v)["params"])
    want, want_grads = _jax_vjp(J, lambda a, b, c: jmod.apply({"params": params}, a, b, c),
                                [J.jnp.asarray(x, jdt) for x in (q, k, v)], cot)
    tmod = t_rd.MultiHeadAttention(heads, 48, 48)
    load_jax_params(tmod, params)

    def port(tdtype):
        ins = [_t(x, tdtype).requires_grad_(True) for x in (q, k, v)]
        out = tmod(*ins)
        return out, torch.autograd.grad(out, ins, _t(cot, out.dtype))

    got, got_grads = port(torch.bfloat16 if bf16 else torch.float32)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    if not bf16:
        _close(got, want, name="output")
        for g, w, name in zip(got_grads, want_grads, "qkv"):
            _close(g, w, dict(rtol=1e-4, atol=1e-5 * float(np.abs(_np(w)).max())), f"grad {name}")
        return
    f32_mod = J.nn.MultiHeadDotProductAttention(num_heads=heads, qkv_features=48)
    f32_out, f32_grads = _jax_vjp(J, lambda a, b, c: f32_mod.apply({"params": params}, a, b, c), [q, k, v], cot)
    _bf16_accuracy([got, *got_grads], [want, *want_grads], [f32_out, *f32_grads], ["output", "q", "k", "v"],
                   "MultiHeadAttention")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_decoder_layer_matches_jax(J, dtype):
    """TransformerDecoderLayer (dropout 0): output and the gradients of tgt, memory and query_pos.
    float32: rtol 1e-5, atol 1e-5 on the output (three LayerNorms and two softmaxes in another
    summation order); gradients rtol 1e-4, atol 1e-5 of the largest entry. bf16: the output and the
    gradients by BF16_ACCURACY (measured: 1.01 at most)."""
    tgt, mem, mem_pos, qpos = _attention_inputs(seed=5)
    cot = np.random.RandomState(6).normal(size=tgt.shape).astype(np.float32)
    bf16 = dtype == "bfloat16"
    jmod = J.rd.TransformerDecoderLayer(d_model=48, dropout=0.0, dtype=J.jnp.bfloat16 if bf16 else None)
    params = J.perturb(jmod.init(J.jax.random.PRNGKey(1), tgt, mem, qpos, mem_pos)["params"])
    want, want_grads = _jax_vjp(J, lambda a, b, c: jmod.apply({"params": params}, a, b, c, mem_pos),
                                [tgt, mem, qpos], cot)
    tmod = t_rd.TransformerDecoderLayer(48, dropout=0.0, dtype=torch.bfloat16 if bf16 else None)
    load_jax_params(tmod, params)

    def port():
        ins = [_t(x).requires_grad_(True) for x in (tgt, mem, qpos)]
        out = tmod(ins[0], ins[1], ins[2], _t(mem_pos))
        return out, torch.autograd.grad(out, ins, _t(cot, out.dtype))

    got, got_grads = port()
    if not bf16:
        _close(got, want, dict(rtol=1e-5, atol=1e-5), "output")
        for g, w, name in zip(got_grads, want_grads, ("tgt", "memory", "query_pos")):
            _close(g, w, dict(rtol=1e-4, atol=1e-5 * float(np.abs(_np(w)).max())), f"grad {name}")
        return
    f32_mod = J.rd.TransformerDecoderLayer(d_model=48, dropout=0.0)
    f32_out, f32_grads = _jax_vjp(J, lambda a, b, c: f32_mod.apply({"params": params}, a, b, c, mem_pos),
                                  [tgt, mem, qpos], cot)
    assert got.dtype == torch.bfloat16
    _bf16_accuracy([got, *got_grads], [want, *want_grads], [f32_out, *f32_grads],
                   ["output", "tgt", "memory", "query_pos"], "TransformerDecoderLayer")


def _decoder_inputs(seed=7, N=2, nr=40):
    rng = np.random.RandomState(seed)
    return rng.normal(size=(N, nr, 48)).astype(np.float32), (rng.normal(size=(N, nr, 3)) * 10).astype(np.float32)


@pytest.mark.parametrize("dtype,aux", [("float32", True), ("float32", False), ("bfloat16", True)])
def test_set_radar_decoder_matches_jax(J, dtype, aux):
    """SetRadarDecoder (16 queries, 2 decoder layers, dropout 0): radar_output, angles, the
    intermediate layer's output under aux_loss ([1, N, Q, 7]) and the gradient of the features
    through all of them (the geometry enters only the positional embedding, which carries no
    gradient). float32 (the JAX encoder through flax's attention, the port's through K2's plain
    version): rtol 1e-4, atol 1e-5 of each output's largest entry; the feature gradient rtol 1e-3,
    atol 1e-4 of its largest entry. bf16 (the JAX encoder's K2 in interpret mode; the heads float32):
    the outputs and the feature gradient by BF16_ACCURACY against the JAX decoder in float32
    (measured: 1.10 at most)."""
    feats, geom = _decoder_inputs()
    bf16 = dtype == "bfloat16"
    jmod = J.rd.SetRadarDecoder(d_model=48, num_queries=16, dropout=0.0, position_scale=30.0, aux_loss=aux,
                                attn_impl="pallas_interpret" if bf16 else "flax",
                                dtype=J.jnp.bfloat16 if bf16 else None)
    params = J.perturb(J.jax.jit(jmod.init)(J.jax.random.PRNGKey(2), feats, geom)["params"])
    rng = np.random.RandomState(8)
    cots = [rng.normal(size=s).astype(np.float32) for s in ((2, 16, 7), (2, 16, 2), (1, 2, 16, 7))[:3 if aux else 2]]
    want, (want_grad,) = _jax_vjp(J, lambda f: jmod.apply({"params": params}, f, geom), [feats], tuple(cots))
    tmod = t_rd.SetRadarDecoder(48, num_queries=16, dropout=0.0, position_scale=30.0, aux_loss=aux,
                                dtype=torch.bfloat16 if bf16 else None)
    load_jax_params(tmod, params)

    def port():
        f, g = _t(feats).requires_grad_(True), _t(geom).requires_grad_(True)
        outs = tmod(f, g)
        assert len(outs) == len(want) == (3 if aux else 2)
        grad, g_grad = torch.autograd.grad(outs, [f, g], [_t(c) for c in cots], allow_unused=True)
        assert g_grad is None
        return outs, grad

    got, got_grad = port()
    assert all(o.dtype == torch.float32 for o in got)
    assert got[0].shape == (2, 16, 7) and got[1].shape == (2, 16, 2)
    if aux:
        assert got[2].shape == (1, 2, 16, 7)
    names = ("radar_output", "angles", "aux")
    if not bf16:
        for g, w, name in zip(got, want, names):
            _close(g, w, dict(rtol=1e-4, atol=1e-5 * float(np.abs(_np(w)).max())), name)
        _close(got_grad, want_grad, dict(rtol=1e-3, atol=1e-4 * float(np.abs(_np(want_grad)).max())), "features")
        return
    f32_mod = J.rd.SetRadarDecoder(d_model=48, num_queries=16, dropout=0.0, position_scale=30.0, aux_loss=aux)
    f32_outs, (f32_grad,) = _jax_vjp(J, lambda f: f32_mod.apply({"params": params}, f, geom), [feats], tuple(cots))
    _bf16_accuracy([*got, got_grad], [*want, want_grad], [*f32_outs, f32_grad], [*names, "features grad"],
                   "SetRadarDecoder")


# ---------------------------------------------------------------------------- losses and assignments


def _radar_inputs(seed=7, N=3, G=12, M=40):
    """gt [N, G, 3] with a validity mask and a prediction [N, M, 7] (existence, point, scale)."""
    rng = np.random.RandomState(seed)
    gt = rng.normal(0, 5, (N, G, 3)).astype(np.float32)
    mask = rng.uniform(size=(N, G)) < 0.7
    pred = np.concatenate([rng.uniform(0.01, 0.99, (N, M, 1)), rng.normal(0, 5, (N, M, 3)),
                           rng.uniform(0.0005, 2, (N, M, 3))], -1).astype(np.float32)
    return gt, mask, pred


@pytest.mark.parametrize("assignment", ["auction", "hungarian"])
@pytest.mark.parametrize("seed", [11, 12])
def test_detr_set_loss_matches_jax(J, assignment, seed):
    """detr_set_loss: value and gradient (rtol 1e-5, atol 1e-6) and the assignment index for index,
    under both solvers; a scan with all rows masked pays the existence term alone."""
    gt, mask, pred = _radar_inputs(seed=seed, M=20)
    mask[1] = False

    def j_loss(p):
        return J.ru.detr_set_loss(gt, mask, p, assignment=assignment)

    (want, want_assign), want_g = J.jax.value_and_grad(j_loss, has_aux=True)(J.jnp.asarray(pred))
    tp = _t(pred).requires_grad_(True)
    got, got_assign = t_ru.detr_set_loss(_t(gt), torch.from_numpy(mask), tp, assignment=assignment)
    got.backward()
    np.testing.assert_array_equal(got_assign.numpy(), np.asarray(want_assign))
    assert (got_assign.numpy()[mask] >= 0).all() and (got_assign.numpy()[~mask] == -1).all()
    _close(got, want, name="detr loss")
    _close(tp.grad, want_g, name="detr grad")


@pytest.mark.parametrize("P,O", [(10, 14), (14, 14), (20, 14)])
def test_hungarian_assignment_matches_jax(J, P, O):
    """hungarian_assignment index for index against the JAX package's (its host function and its
    pure_callback inside jit), with masked rows, a scan whose rows are all masked, and P > O, where
    the rows left over stay at -1; one host round trip a call."""
    rng = np.random.RandomState(P + O)
    cost = rng.normal(0, 3, (4, P, O)).astype(np.float32)
    mask = rng.uniform(size=(4, P)) < 0.8
    mask[2] = False
    mask[3] = True
    want = np.asarray(J.jax.jit(lambda c, m: J.ru.solve_assignment(c, m, "hungarian"))(cost, mask))
    np.testing.assert_array_equal(want, J.ru._hungarian_host(cost, mask))
    with trace.recording():
        got = t_ru.solve_assignment(torch.from_numpy(cost), torch.from_numpy(mask), "hungarian")
    assert trace.snapshot().total("hungarian_calls") == 1
    assert got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[~mask] == -1).all()
    for b in range(4):
        cols = got.numpy()[b][got.numpy()[b] >= 0]
        assert len(cols) == min(int(mask[b].sum()), O) and len(set(cols)) == len(cols)


def test_auction_more_rows_than_columns(J):
    """P > O (a user's num_radar_queries below max_radar_gt): the port's auction gives the JAX
    auction's assignment index for index; the JAX loop runs to max_iters and leaves the rows left
    over at -1, at least valid rows - O of them per scan."""
    gt, mask, pred = _radar_inputs(seed=21, N=3, G=20, M=12)
    for method in ("euclidean", "nll"):
        cost = np.asarray(J.jax.vmap(lambda g, m, p: J.ru.radar_cost_matrix(g, m, p, method))(gt, mask, pred))
        want = np.asarray(J.ru.solve_assignment(cost, mask, "auction"))
        got = t_ru.auction_assignment(torch.from_numpy(cost), torch.from_numpy(mask)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=method)
        for b in range(3):
            assert (got[b][mask[b]] == -1).sum() >= mask[b].sum() - 12, method
            assigned = got[b][got[b] >= 0]
            assert len(set(assigned)) == len(assigned)


@pytest.mark.parametrize("assignment", ["auction", "hungarian"])
@pytest.mark.parametrize("training", [True, False])
def test_euclidean_radar_loss(J, training, assignment):
    """calculate_radar_loss with the euclidean loss: the association cost is euclidean in training
    and in eval; value and gradient rtol 1e-5, atol 1e-6, the assignment index for index."""
    gt, mask, pred = _radar_inputs(seed=9)

    def j_loss(p):
        return J.ru.calculate_radar_loss(gt, mask, p, "euclidean", training, assignment)

    (want, want_assign), want_g = J.jax.value_and_grad(j_loss, has_aux=True)(J.jnp.asarray(pred))
    tp = _t(pred).requires_grad_(True)
    got, got_assign = t_ru.calculate_radar_loss(_t(gt), torch.from_numpy(mask), tp, "euclidean", training, assignment)
    got.backward()
    np.testing.assert_array_equal(got_assign.numpy(), np.asarray(want_assign))
    _close(got, want, name="euclidean loss")
    _close(tp.grad, want_g, name="euclidean grad")
    with pytest.raises(ValueError):
        t_ru.calculate_radar_loss(_t(gt), torch.from_numpy(mask), tp, "l2", training, assignment)
    with pytest.raises(ValueError):
        t_ru.solve_assignment(torch.zeros((1, 2, 2)), torch.ones((1, 2), dtype=torch.bool), "greedy")


@pytest.mark.parametrize("threshold,max_detections", [(0.3, 1000), (0.5, 40), (0.9, 1000)])
def test_sample_radar_points_euclidean(J, threshold, max_detections):
    """The deterministic sampler (the means of the components above the threshold, within the
    budget of the highest existences, ties ordered as jnp.argsort's stable sort): exact."""
    rng = np.random.RandomState(4)
    ro = rng.normal(size=(300, 7)).astype(np.float32)
    ro[:, 0] = rng.uniform(0, 1, 300)
    ro[:9, 0] = 1.0
    want = J.ru.sample_radar_points(J.jnp.asarray(ro), "euclidean", threshold=threshold,
                                    max_detections=max_detections)
    got = t_ru.sample_radar_points(torch.from_numpy(ro), "euclidean", threshold=threshold,
                                   max_detections=max_detections)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# ---------------------------------------------------------------------------- dropout (the port alone)


def test_set_decoder_dropout_structure():
    """Training dropout at rate 0.1: the attention masks are one [Q, Q] and one [Q, nr] draw per
    decode group and per attention, applied alike to every scan and head of the group; the residual
    masks are per scan; slicing a group's draws gives its scans' per-scan draws and its own masks, and
    decoding the groups one by one gives what decoding them with those slices gives. The keep rate of
    the 0.1 masks is 0.9 within 5 binomial standard deviations."""
    torch.manual_seed(0)
    dec = t_rd.SetRadarDecoder(48, num_queries=QUERIES, dropout=0.1, aux_loss=True)
    ns, nr, groups = 4, 30, 2
    noise = dec.draw_noise(ns, nr, torch.Generator().manual_seed(3), "cpu", groups)
    assert noise["group_scans"] == 2 and len(noise["encoder"]) == 1 and len(noise["layers"]) == 2
    for layer in noise["layers"]:
        assert layer["self_attn"].shape == (groups, QUERIES, QUERIES)
        assert layer["cross_attn"].shape == (groups, QUERIES, nr)
        assert all(layer[k].shape == (ns, QUERIES, 48) for k in ("drop1", "drop2", "drop3"))
        assert not torch.equal(layer["cross_attn"][0], layer["cross_attn"][1])
    second = dec.slice_noise(noise, 2, 4)
    for full, cut in zip(noise["layers"], second["layers"]):
        assert torch.equal(cut["cross_attn"][0], full["cross_attn"][1])
        assert torch.equal(cut["drop2"], full["drop2"][2:4])
    assert second["encoder"][0]["seed"] == t_attention.batch_offset_seed(noise["encoder"][0]["seed"], 2)
    with pytest.raises(ValueError):
        dec.slice_noise(noise, 1, 3)

    keeps = torch.cat([(layer[k] < 0.9).flatten() for layer in noise["layers"] for k in ("self_attn", "cross_attn")])
    n = keeps.numel()
    assert abs(float(keeps.float().mean()) - 0.9) < 5 * (0.9 * 0.1 / n) ** 0.5

    # an attention's mask is broadcast over the batch and the heads: two identical scans stay identical
    attn = t_rd.MultiHeadAttention(2, 48, 48)
    x = torch.randn(1, QUERIES, 48).expand(3, QUERIES, 48)
    u = torch.rand(1, QUERIES, QUERIES)
    out = attn(x, x, x, 0.1, u)
    assert torch.equal(out[0], out[1]) and torch.equal(out[0], out[2])
    assert not torch.allclose(out, attn(x, x, x))
    # the weights a mask keeps are scaled by 1 / 0.9, the others dropped
    q = torch.randn(2, 5, 48)
    k = torch.randn(2, 7, 48)
    one = t_rd.MultiHeadAttention(1, 48, 48)
    u = torch.rand(1, 5, 7)
    for layer in (one.query, one.key, one.value, one.out):
        torch.nn.init.eye_(layer.weight)
        torch.nn.init.zeros_(layer.bias)
    w = torch.softmax(q @ k.transpose(1, 2) / 48**0.5, -1) * (u < 0.9) / 0.9
    torch.testing.assert_close(one(q, k, k, 0.1, u), w @ k, rtol=1e-5, atol=1e-6)

    feats, geom = (torch.from_numpy(a) for a in _decoder_inputs(N=ns, nr=nr))
    with torch.no_grad():
        groups_out = [dec.decode(feats[i:i + 2], geom[i:i + 2], dec.slice_noise(noise, i, i + 2)) for i in (0, 2)]
        again = dec.decode(feats[2:4], geom[2:4], second)
        eval_out = dec(feats, geom)
    assert all(torch.equal(a, b) for a, b in zip(again, groups_out[1]))
    assert not torch.allclose(groups_out[0][0], eval_out[0][:2])


# ---------------------------------------------------------------------------- the set model


def _shrink(m):
    """The tiny sizes of tests/test_torch_slice.shrink, with the set decoder (flips and dropout off)."""
    m.field.grid.static.log2_hashmap_size = 12
    m.field.grid.actor.log2_hashmap_size = 10
    for pf in (m.sampling.proposal_field_1, m.sampling.proposal_field_2):
        pf.grid.static.log2_hashmap_size = 11
        pf.grid.actor.log2_hashmap_size = 9
    m.sampling.num_proposal_samples = (16, 8)
    m.sampling.num_nerf_samples = 6
    m.loss.vgg_mult = 0.0
    m.radar_decoder_type = "set"
    m.num_radar_queries = QUERIES
    m.field.grid.actor.flip_prob = 0.0
    m.radar_transformer_dropout = 0.0
    return m


def _port_outputs():
    out = t_synthetic.SyntheticDataParser(t_synthetic.SyntheticDataParserConfig(**SCENE)).get_dataparser_outputs()
    out.radar_fov = dict(RADAR_FOV)
    return out


# bf16 steps: nff_chunks 2 and 2 radar decode groups, the production program's knobs, as in
# tests/test_torch_bf16_train.py
CHUNKS = 2


# The float32 step associates by the exact Hungarian: at init the set decoder's queries have near-equal
# costs, the auction does not converge in its rounds there (rows end unassigned), and the frameworks'
# last-ulp cost differences (1.4e-5 here) then change its result. The bf16 step pins the association.
STEP_ASSIGNMENT = "hungarian"


def _model_knobs(m, dtype, loss):
    m.compute_dtype = dtype
    m.loss.radar_set_loss = loss
    m.loss.radar_assignment = STEP_ASSIGNMENT
    m.nff_chunks = CHUNKS if dtype == "bfloat16" else 1
    m.radar_decode_chunks = 2
    return m


@pytest.fixture(scope="module")
def jax_side(J):
    """The tiny JAX pipelines with the set decoder (float32 and bf16, whose K2 runs in interpret
    mode), one set of perturbed variables (the parameter tree does not depend on the dtype or the
    loss), a batch and the jitter, and the step results, computed on first use."""
    from neuradar_tpu.data import datamanager as j_dm
    from neuradar_tpu.data.dataparsers.synthetic import SyntheticDataParser, SyntheticDataParserConfig
    from neuradar_tpu.pipelines.ad_neuradar_pipeline import ADNeuRadarPipeline, ADNeuRadarPipelineConfig
    from tests.test_torch_slice import perturb

    out = SyntheticDataParser(SyntheticDataParserConfig(**SCENE)).get_dataparser_outputs()
    out.radar_fov = dict(RADAR_FOV)
    pipes = {}
    for dtype in ("float32", "bfloat16"):
        cfg = ADNeuRadarPipelineConfig(datamanager=j_dm.ADDataManagerConfig(**DM))
        _model_knobs(_shrink(cfg.model), dtype, "mb")
        cfg.model.use_pallas_attention = dtype == "bfloat16"
        pipes[dtype] = ADNeuRadarPipeline(cfg, out)
    variables = pipes["float32"].init_variables(0)
    params, batch_stats = perturb(variables["params"], variables["batch_stats"])
    batch = j_dm.ADDataManager(out, j_dm.ADDataManagerConfig(**DM)).sample_train_batch()
    layout = pipes["float32"].layout
    m = pipes["float32"].config.model
    rng = np.random.RandomState(21)
    jitter = [rng.uniform(size=(layout.total, 1)).astype(np.float32)
              for _ in (*m.sampling.num_proposal_samples, m.sampling.num_nerf_samples)]
    return SimpleNamespace(J=J, pipes=pipes, params=params, batch_stats=batch_stats, batch=batch, jitter=jitter,
                           layout=layout, steps={})


def _pinned_assignment(batch, layout) -> np.ndarray:
    """One fixed association of the batch's GT rows: the port's auction on the euclidean cost of a
    seeded prediction."""
    prng = np.random.RandomState(5)
    pinned = np.concatenate([prng.uniform(0.2, 0.8, (layout.num_radar_scans, QUERIES, 1)),
                             prng.normal(0, 20, (layout.num_radar_scans, QUERIES, 3)),
                             prng.uniform(0.5, 2.0, (layout.num_radar_scans, QUERIES, 3))], -1).astype(np.float32)
    gt, mask = torch.from_numpy(batch["radar_gt"]), torch.from_numpy(batch["radar_gt_mask"])
    return t_ru.auction_assignment(t_ru.radar_cost_matrix(gt, mask, _t(pinned), "euclidean"), mask).numpy()


def _port_step(s, loss, dtype, pin):
    """The port's set model on the same weights, batch and jitter (a bf16 chunk's jitter is the JAX
    chunk body's, tiled), with the association pinned when ``pin``."""
    cfg = t_pipeline.ADNeuRadarPipelineConfig(datamanager=t_dm.ADDataManagerConfig(**DM))
    _model_knobs(_shrink(cfg.model), dtype, loss)
    pipe = t_pipeline.ADNeuRadarPipeline(cfg, _port_outputs(), "cpu")
    load_jax_params(pipe.model, s.params, s.batch_stats)
    chunks = CHUNKS if s.pipes[dtype].config.model.compute_dtype == "bfloat16" else 1
    queue = [np.tile(j[: s.layout.total // chunks], (chunks, 1)) for j in s.jitter]

    def t_uniform(generator, shape, device):
        arr = queue.pop(0)
        assert tuple(shape) == arr.shape, (shape, arr.shape)
        return torch.from_numpy(arr).to(device)

    mp = pytest.MonkeyPatch()
    mp.setattr(t_rng, "uniform", t_uniform)
    if pin:
        pinned = torch.from_numpy(_pinned_assignment(s.batch, s.layout))
        mp.setattr(t_ru, "solve_assignment", lambda cost, row_mask, method="auction": pinned.to(cost.device))
    try:
        model = pipe.model
        model.train()
        model.zero_grad()
        total, losses, _ = pipe.make_train_loss_fn()(s.batch, torch.Generator().manual_seed(0))
        total.backward()
    finally:
        mp.undo()
    assert not queue
    grads = {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p) for n, p in model.named_parameters()}
    return dict(total=total.detach(), losses={k: v.detach() for k, v in losses.items()}, grads=grads, pipe=pipe)


def test_set_model_parameters_and_groups(jax_side):
    """The JAX set model's parameter tree fills every parameter of the port's (load_jax_params raises
    otherwise); every radar-decoder parameter, query_embed among them, is in the "transformer"
    group, as the JAX package labels it; init_params draws query_embed from a normal of std 1 with
    the seeded generator."""
    from neuradar_tpu.engine import optimizers as j_opt

    s = jax_side
    got = _port_step(s, "mb", "float32", pin=False)["pipe"].model
    opt = t_opt.GroupedOptimizer(got, t_opt.default_optimizer_groups(2001))
    flat = {}
    s.J.jax.tree_util.tree_map_with_path(lambda p, _: flat.setdefault(tuple(k.key for k in p), None),
                                         s.params["radar_decoder"])
    assert ("query_embed",) in flat and ("layer_1", "cross_attn", "out", "kernel") in flat
    for path in flat:
        assert j_opt.param_group_label(("radar_decoder", *path)) == "transformer"
    decoder = {n: lab for n, lab in opt.labels.items() if n.startswith("radar_decoder.")}
    assert decoder["radar_decoder.query_embed"] == "transformer" and set(decoder.values()) == {"transformer"}
    assert len(decoder) == len(flat)

    cfg = t_pipeline.ADNeuRadarPipelineConfig(datamanager=t_dm.ADDataManagerConfig(**DM))
    _shrink(cfg.model).num_radar_queries = 300
    a, b = (t_pipeline.ADNeuRadarPipeline(cfg, _port_outputs(), "cpu", seed=4) for _ in range(2))
    qa, qb = a.model.radar_decoder.query_embed, b.model.radar_decoder.query_embed
    assert qa.shape == (300, 48) and torch.equal(qa, qb)
    assert abs(float(qa.mean())) < 0.05 and 0.95 < float(qa.std()) < 1.05
    init_params(b.model, seed=5)
    assert not torch.equal(qa, b.model.radar_decoder.query_embed)


@pytest.mark.parametrize("loss_type", ["nll", "euclidean"])
def test_set_eval_radar_metrics_match_jax(jax_side, loss_type):
    """The set model's ten radar metrics with the JAX weights: 'nll' over the eval scans x 2 rounds,
    the port fed the uniforms that JAX's loop draws; 'euclidean' deterministic in one round. The
    empty-prediction count exactly, the distances rtol 1e-4 (the renders agree to 1e-4 and the
    sampled points move with them); render_radar gives [Q, 7]."""
    s = jax_side
    J = s.J
    jpipe = s.pipes["float32"]
    jpipe.config.model.loss.radar_loss_type = loss_type
    tpipe = _port_step(s, "mb", "float32", pin=False)["pipe"]
    tpipe.model.eval()
    tpipe.config.model.loss.radar_loss_type = loss_type
    variables = {"params": s.params, "batch_stats": s.batch_stats}
    rounds = 2 if loss_type == "nll" else None
    try:
        want = jpipe.get_average_eval_radar_metrics(variables, sampling_rounds=rounds)
    finally:
        jpipe.config.model.loss.radar_loss_type = "nll"
    rng, queue = J.jax.random.PRNGKey(0), []
    for _ in tpipe.datamanager.eval_radar_indices():
        for _ in range(rounds or 0):
            rng, sub = J.jax.random.split(rng)
            k1, k2 = J.jax.random.split(sub)
            queue.append((np.array(J.jax.random.uniform(k1, (QUERIES,), J.jnp.float32)),
                          np.array(J.jax.random.uniform(k2, (QUERIES, 3), minval=-0.5 + 1e-6, maxval=0.5 - 1e-6))))

    def draw(n_mb):
        assert n_mb == QUERIES
        return tuple(torch.from_numpy(u) for u in queue.pop(0))

    got = tpipe.get_average_eval_radar_metrics(sampling_rounds=rounds, draw=draw)
    assert not queue, "every round drew"
    assert sorted(got) == sorted(want)
    assert got["n_empty_pred_radar"] == want["n_empty_pred_radar"]
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)
    assert tpipe.render_radar(0)["radar_output"].shape == (QUERIES, 7)


def test_validate_learning_set_decoder_hungarian(tmp_path):
    """validate_learning --set-decoder --radar-assignment hungarian for 4 float32 steps of the tiny
    scale on the CPU: it trains the set model with the multi-Bernoulli loss and the host's Hungarian,
    and the report and the curves record both flags (4 steps are too few for its PASS to mean
    anything; float32 because bf16 is slow on the CPU)."""
    with trace.recording():
        rc = validate_learning.main(["--scale", "tiny", "--iters", "4", "--eval-every", "2", "--device", "cpu",
                                     "--no-bf16", "--set-decoder", "--radar-assignment", "hungarian",
                                     "--output-dir", str(tmp_path)])
    assert rc in (0, 1)
    (report_path,) = tmp_path.glob("*/neuradar/learning_check.json")
    report = json.loads(report_path.read_text())
    assert report["set_decoder"] is True and report["radar_assignment"] == "hungarian"
    curve = json.loads((report_path.parent / "learning_curve.json").read_text())
    assert curve["set_decoder"] is True and curve["radar_assignment"] == "hungarian"
    assert all(np.isfinite(v) for _, v in curve["curves"]["radar_loss"])
    assert curve["dtype"] == "float32"
    # 4 train steps with the main and the aux loss, and the eval batch at step 2 with the main loss
    assert trace.snapshot().total("hungarian_calls") == 4 * 2 + 1


def test_set_config_reaches_the_model_through_the_cli():
    """The dotted overrides set the new string and bool fields as scripts/train.py parses them, and
    the model they build has the set decoder; an unknown decoder type or set loss raises."""
    from neuradar_tpu_torch.configs.cli import parse_overrides
    from neuradar_tpu_torch.configs.method_configs import get_method

    cfg = get_method("neuradar-synthetic")
    m = cfg.pipeline.model
    assert (m.radar_decoder_type, m.num_radar_queries, m.radar_set_aux_loss) == ("encoder", 300, True)
    assert (m.loss.radar_loss_type, m.loss.radar_assignment, m.loss.radar_set_loss) == ("nll", "auction", "mb")
    parse_overrides(cfg, ["--pipeline.model.radar_decoder_type", "set", "--pipeline.model.loss.radar_set_loss", "detr",
                          "--pipeline.model.loss.radar_assignment", "hungarian",
                          "--pipeline.model.radar_set_aux_loss", "False", "--pipeline.model.num_radar_queries", "32",
                          "--pipeline.model.loss.radar_loss_type", "euclidean"])
    assert (m.radar_decoder_type, m.num_radar_queries, m.radar_set_aux_loss) == ("set", 32, False)
    assert (m.loss.radar_loss_type, m.loss.radar_assignment, m.loss.radar_set_loss) == ("euclidean", "hungarian",
                                                                                         "detr")
    cfg = t_pipeline.ADNeuRadarPipelineConfig(datamanager=t_dm.ADDataManagerConfig(**DM))
    _shrink(cfg.model).radar_set_aux_loss = False
    pipe = t_pipeline.ADNeuRadarPipeline(cfg, _port_outputs(), "cpu")
    assert isinstance(pipe.model.radar_decoder, t_rd.SetRadarDecoder) and not pipe.model.radar_decoder.aux_loss
    for field, value in (("radar_decoder_type", "detr"), ("loss.radar_set_loss", "hungarian")):
        bad = t_pipeline.ADNeuRadarPipelineConfig(datamanager=t_dm.ADDataManagerConfig(**DM))
        _shrink(bad.model)
        parse_overrides(bad, [f"--model.{field}", value])
        with pytest.raises(ValueError):
            t_pipeline.ADNeuRadarPipeline(bad, _port_outputs(), "cpu")


# ---------------------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tiny_set_pipeline(device, loss="detr", dropout=0.1):
    """The tiny set model with flips and dropout on, associating by STEP_ASSIGNMENT (the card's last-bit
    cost differences change the unconverged auction's result, as the frameworks' do)."""
    cfg = t_pipeline.ADNeuRadarPipelineConfig(datamanager=t_dm.ADDataManagerConfig(**DM))
    m = _shrink(cfg.model)
    m.loss.radar_set_loss = loss
    m.loss.radar_assignment = STEP_ASSIGNMENT
    m.radar_transformer_dropout = dropout
    m.field.grid.actor.flip_prob = 0.5
    m.radar_decode_chunks = 2
    return t_pipeline.ADNeuRadarPipeline(cfg, _port_outputs(), device, seed=0)


@pytest.mark.cuda
def test_set_model_render_on_card_matches_cpu(cuda):
    """render_radar of two scans with the set decoder, through K2 on the card against the plain
    version on the CPU, same weights: rtol 1e-4, atol 1e-4; K2's forward launched."""
    gpu, cpu = _tiny_set_pipeline(cuda), _tiny_set_pipeline("cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    with trace.recording():
        got = gpu.render_radar([0, 5])["radar_output"]
    assert trace.snapshot().total("launches/self_attention_fwd") > 0
    assert got.shape == (2, QUERIES, 7)
    torch.testing.assert_close(got.cpu(), cpu.render_radar([0, 5])["radar_output"], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["mb", "detr"])
def test_set_model_train_step_on_card_matches_cpu(cuda, loss):
    """One tiny float32 train step of the set model (deep supervision, flips and dropout on, the
    draws from one CPU generator, the Hungarian), K2 forward and backward on the card against the
    plain versions on the CPU: loss terms rtol 1e-4, atol 1e-6; gradients rtol 1e-3, atol 1e-4 of the parameter's
    largest gradient (at least 1e-7), a parameter whose CPU gradient stays under 1e-6 within 1e-6."""
    gpu, cpu = _tiny_set_pipeline(cuda, loss), _tiny_set_pipeline("cpu", loss)
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    batch = gpu.datamanager.sample_train_batch()
    results = []
    with trace.recording():
        for pipe in (gpu, cpu):
            pipe.model.train()
            pipe.model.zero_grad()
            total, losses, _ = pipe.make_train_loss_fn()(batch, torch.Generator().manual_seed(7))
            total.backward()
            results.append(({"total": total.detach().cpu(), **{k: v.detach().cpu() for k, v in losses.items()}},
                            {n: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
                             for n, p in pipe.model.named_parameters()}))
    snap = trace.snapshot()
    assert snap.total("launches/self_attention_fwd") > 0 and snap.total("launches/self_attention_bwd") > 0
    (g_loss, g_grad), (c_loss, c_grad) = results
    assert "radar_aux_loss" in c_loss
    for key, c in c_loss.items():
        torch.testing.assert_close(g_loss[key], c, rtol=1e-4, atol=1e-6, msg=key)
    for name, c in c_grad.items():
        scale = float(c.abs().max())
        torch.testing.assert_close(g_grad[name], c, rtol=1e-3, atol=1e-6 if scale < 1e-6 else max(1e-4 * scale, 1e-7),
                                   msg=name)
