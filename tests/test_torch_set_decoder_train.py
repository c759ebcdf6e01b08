"""The tiny train step of the port's set radar decoder model against the JAX package's, in float32
and in bf16, with the multi-Bernoulli and the DETR set loss: every loss term, radar_aux_loss
included, and every gradient against jax.value_and_grad of the JAX pipeline's train loss. The
scene, the weights, the draws and the other tests of the set model are in
tests/test_torch_set_decoder.py, whose fixtures and helpers this file takes; the steps run in a file
of their own, so that a parallel run (``--dist loadfile``) puts their JAX compiles on a worker of
their own. Each test states its tolerance, taken from the rules of tests/test_torch_train.py
(float32) and tests/test_torch_bf16_train.py (bf16).
"""

import re

import numpy as np
import pytest

from neuradar_tpu_torch.models import neuradar as t_model
from neuradar_tpu_torch.utils.params import load_jax_params
from tests.test_torch_set_decoder import (  # noqa: F401 (J and jax_side are fixtures)
    BF16_ACCURACY,
    CHUNKS,
    GRAD_SHARE,
    J,
    _close,
    _pinned_assignment,
    _port_step,
    jax_side,
)

SET_LOSSES = ("mb", "detr")


def _jax_step(s, loss, dtype):
    """value_and_grad of the JAX set model's train loss; a bf16 step with the association pinned. The
    multi-Bernoulli and the DETR loss are traced into one jit, one compile a dtype (the two graphs
    differ in their radar loss terms alone), and both results are kept."""
    key = (loss, dtype)
    if key in s.steps:
        return s.steps[key]
    J = s.J
    jax, jnp = J.jax, J.jnp
    pipe = s.pipes[dtype]
    n = s.layout.total // (CHUNKS if dtype == "bfloat16" else 1)
    calls = [0]
    uniform = jax.random.uniform

    def j_uniform(k, shape=(), dt=jnp.float32, *args, **kwargs):
        # the samplers' [R / chunks, 1] jitter, round after round on every trace of the chunk body
        if tuple(shape) == (n, 1):
            arr = s.jitter[calls[0] % len(s.jitter)][:n]
            calls[0] += 1
            return jnp.asarray(arr)
        return uniform(k, shape, dt, *args, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "uniform", j_uniform)
    if dtype == "bfloat16":
        pinned = _pinned_assignment(s.batch, s.layout).astype(np.int32)
        mp.setattr(J.ru, "solve_assignment", lambda cost, row_mask, method="auction": jnp.asarray(pinned))
    step = jax.value_and_grad(pipe.make_train_loss_fn(), has_aux=True)

    def both(*args):
        out = {}
        for set_loss in SET_LOSSES:  # the model reads the loss from its config as it is traced
            mp.setattr(pipe.config.model.loss, "radar_set_loss", set_loss)
            out[set_loss] = step(*args)
        return out

    try:
        results = jax.jit(both)(s.params, s.batch_stats, jax.tree.map(jnp.asarray, s.batch), jax.random.PRNGKey(0))
    finally:
        mp.undo()
    assert calls[0] and calls[0] % len(s.jitter) == 0
    for set_loss, ((total, (losses, _, stats)), grads) in results.items():
        s.steps[(set_loss, dtype)] = (total, losses, stats, grads)
    return s.steps[key]


def _jax_grads(pipe, grads, stats):
    from neuradar_tpu_torch.model_components.dynamic_actors import trajectories_from_dicts

    model = pipe.model
    want = t_model.NeuRadarModel(model.config, model.scene, trajectories_from_dicts(pipe.outputs.trajectories))
    load_jax_params(want, grads, stats)
    return {n: p.detach() for n, p in want.named_parameters()}


@pytest.mark.parametrize("loss", ["mb", "detr"])
def test_set_train_step_float32(jax_side, loss):
    """The float32 train step of the set model (deep supervision on) against the JAX step, the
    association solved by the Hungarian on both sides (STEP_ASSIGNMENT): the total and every loss
    term, radar_aux_loss
    among them, rtol 1e-4, atol 1e-6; every gradient rtol 1e-3, atol 1e-4 of the parameter's
    largest gradient (at least 1e-7), a parameter whose JAX gradient stays under 1e-6 (an exact 0)
    within 1e-6; query_embed's gradient is not 0."""
    s = jax_side
    j_total, j_losses, j_stats, j_grads = _jax_step(s, loss, "float32")
    got = _port_step(s, loss, "float32", pin=False)
    assert "radar_aux_loss" in j_losses and sorted(got["losses"]) == sorted(j_losses)
    for key in j_losses:
        _close(got["losses"][key], j_losses[key], dict(rtol=1e-4, atol=1e-6), key)
    _close(got["total"], j_total, dict(rtol=1e-4, atol=1e-6), "total")
    want = _jax_grads(got["pipe"], j_grads, j_stats)
    assert sorted(want) == sorted(got["grads"])
    for name, g in got["grads"].items():
        scale = float(want[name].abs().max())
        _close(g, want[name], dict(rtol=1e-3, atol=1e-6 if scale < 1e-6 else max(1e-4 * scale, 1e-7)), name)
    assert float(got["grads"]["radar_decoder.query_embed"].abs().max()) > 0


# bf16 gradients, as tests/test_torch_bf16_train.py holds them: a parameter whose JAX gradient stays
# under GRAD_FLOOR of the step's largest entry (an exact 0: rounding alone) within that floor; the
# proposal densities' output biases, scalar sums over every sample in bf16 that the two frameworks
# add in other orders, to a tenth of their value
GRAD_FLOOR = 2e-4
GRAD_PEAK_SHARE = {"proposal_field_0.density_decoder.output.bias": 0.1,
                   "proposal_field_1.density_decoder.output.bias": 0.1}
# The set decoder's attention query and key projections get their gradients through the bf16 softmax
# backward alone, whose sums XLA and torch round in other orders (test_multi_head_attention_matches_flax);
# there the port's and JAX's gradients are equally far from float32 with independent errors, so the
# share rule does not fit them (measured shares up to 1.43). Each is held by its accuracy instead, as
# the bf16 modules are: |port - port float32| <= BF16_ACCURACY x |JAX - port float32| in L2 (measured:
# 1.11 at most)
SOFTMAX_PATH = re.compile(r"radar_decoder\.layer_\d+\.(self_attn|cross_attn)\.(query|key)\.")
LOSS_RTOL = 1e-3
# The radar terms of the bf16 step (radar_loss, radar_aux_loss) come out of five bf16 blocks (the
# encoder and two decoder layers of two attentions each); inputs that differ in their float32 last
# bits flip bf16 roundings there, so these terms are held as the gradients are: |port - JAX| within
# GRAD_SHARE of |port bf16 - port float32| (measured: 1.1e-3 to 1.35e-3 relative, 0.013 to 0.19 of
# what bf16 moves them; on identical inputs the decoder agrees to 1e-4 roundings, see
# test_set_radar_decoder_matches_jax)
RADAR_TERMS = ("radar_loss", "radar_aux_loss")


@pytest.mark.parametrize("loss", ["mb", "detr"])
def test_set_train_step_bf16(jax_side, loss):
    """The bf16 step of the set model (nff_chunks 2, 2 radar groups, the JAX encoder's K2 in
    interpret mode), the association pinned on both sides: every loss term but RADAR_TERMS, and the
    total, rtol LOSS_RTOL (measured: 2.3e-4 at most); RADAR_TERMS and each gradient within
    GRAD_SHARE of the port's own bf16-to-float32 distance in L2 (GRAD_FLOOR, GRAD_PEAK_SHARE and
    SOFTMAX_PATH as named), and all gradients together within GRAD_SHARE too (measured: 0.048)."""
    s = jax_side
    j_total, j_losses, j_stats, j_grads = _jax_step(s, loss, "bfloat16")
    got = _port_step(s, loss, "bfloat16", pin=True)
    f32 = _port_step(s, loss, "float32", pin=True)
    assert "radar_aux_loss" in j_losses and sorted(got["losses"]) == sorted(j_losses)
    rel = {k: abs(float(got["losses"][k]) - float(v)) / abs(float(v)) for k, v in j_losses.items()
           if k not in RADAR_TERMS}
    print(f"set bf16 step ({loss}): largest relative difference of the other terms {max(rel.values()):.3g} "
          f"({max(rel, key=rel.get)})")
    for key in j_losses:
        g, w, f = (float(x) for x in (got["losses"][key], j_losses[key], f32["losses"][key]))
        if key in RADAR_TERMS:
            print(f"set bf16 step ({loss}): {key} share {abs(g - w) / abs(g - f):.3g}")
            assert abs(g - w) <= GRAD_SHARE * abs(g - f), (key, g, w, f)
        else:
            np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, err_msg=key)
    np.testing.assert_allclose(float(got["total"]), float(j_total), rtol=LOSS_RTOL)
    want = _jax_grads(got["pipe"], j_grads, j_stats)
    floor = GRAD_FLOOR * max(float(w.abs().max()) for w in want.values())
    num = dtype_num = 0.0
    shares, accuracy = {}, {}
    for name, g in got["grads"].items():
        w = want[name]
        err, dtype_err, peak = (g - w).norm(), (g - f32["grads"][name]).norm(), float(w.abs().max())
        if name in GRAD_PEAK_SHARE:
            assert float((g - w).abs().max()) <= GRAD_PEAK_SHARE[name] * peak, name
        elif peak < floor:
            assert float((g - w).abs().max()) <= floor, (name, float((g - w).abs().max()), floor)
        elif SOFTMAX_PATH.match(name):
            accuracy[name] = float(dtype_err / (w - f32["grads"][name]).norm())
            assert accuracy[name] <= BF16_ACCURACY, (name, accuracy[name])
        else:
            shares[name] = float(err / dtype_err)
            assert err <= GRAD_SHARE * dtype_err, (name, float(err), float(dtype_err))
        num += float(err**2)
        dtype_num += float(dtype_err**2)
    worst = max(shares, key=shares.get)
    print(f"set bf16 step ({loss}): largest share {shares[worst]:.3g} ({worst}), all gradients "
          f"{(num / dtype_num) ** 0.5:.3g}; softmax-path accuracy at most {max(accuracy.values(), default=0):.3g}")
    assert num**0.5 < GRAD_SHARE * dtype_num**0.5
    assert float(got["grads"]["radar_decoder.query_embed"].abs().max()) > 0


