"""The port's bfloat16 compute path (``compute_dtype``) against the JAX package's, module by module,
on the CPU; and the VGG perceptual loss, the hoisted table cast and grouped radar decoding.

Inputs come from numpy seeds and go to both sides; flax parameters enter the port through
``load_jax_params``. The port rounds where the JAX package rounds: a bf16 layer rounds its product
and then its bias sum (flax's ``Dense(dtype=bf16)``), and the hash encode sums its 8 corner terms
in float32 and rounds once (as XLA reduces bf16). Where an order of summation still differs (a
scatter-add of gradients, a backward), a test holds the port to a bound in units of bf16's
rounding (2^-8 of a value, ``BF16``) and says what it measured; the float32 path of every module
is covered at float32 tolerances by tests/test_torch_modules.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuradar_tpu.field_components import encodings as j_enc
from neuradar_tpu.field_components import mlp as j_mlp
from neuradar_tpu.model_components import radar_decoder as j_radar
from neuradar_tpu.model_components import vgg as j_vgg
from neuradar_tpu_torch.field_components import encodings as t_enc
from neuradar_tpu_torch.field_components import mlp as t_mlp
from neuradar_tpu_torch.fields import neurad_field as t_field
from neuradar_tpu_torch.model_components import radar_decoder as t_radar
from neuradar_tpu_torch.model_components import vgg as t_vgg
from neuradar_tpu_torch.utils.params import init_params, load_jax_params
from tests.test_torch_modules import _perturbed

BF16 = 2.0**-8  # bf16's relative rounding (8 significant bits)


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _err(got, want) -> float:
    return float(np.abs(_np(got) - _np(want)).max())


# ---------------------------------------------------------------------------- (a) MLP, HashEncoding


def test_mlp_bf16():
    """Three layers at width 32 in bf16, output cast back to float32: held to two bf16 units of the
    largest output (measured: equal bit for bit, as each layer rounds where flax's does), and at
    least 4x closer to the JAX bf16 output than the port's float32 MLP is (so bf16 did run)."""
    x = np.random.RandomState(0).normal(size=(512, 16)).astype(np.float32)
    jmod = j_mlp.MLP(out_dim=8, num_layers=3, layer_width=32, compute_dtype=jnp.bfloat16)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jmod.apply(params, jnp.asarray(x))
    assert want.dtype == jnp.float32
    tmod = t_mlp.MLP(16, 8, num_layers=3, layer_width=32, compute_dtype=torch.bfloat16)
    load_jax_params(tmod, params["params"])
    got = tmod(torch.from_numpy(x))
    assert got.dtype == torch.float32
    scale = float(np.abs(want).max())
    assert _err(got, want) <= 2 * BF16 * scale
    tmod.compute_dtype = None
    f32_err = _err(tmod(torch.from_numpy(x)), want)
    print(f"bf16 MLP: port - JAX {_err(got, want):.3g}, port float32 - JAX bf16 {f32_err:.3g}, scale {scale:.3g}")
    assert f32_err > 4 * _err(got, want) + BF16 * scale / 4


@pytest.mark.parametrize("d", [3, 4])
def test_hash_encoding_bf16(d):
    """The table and the positions in bf16; the scalings take the positions' dtype, so the corner
    cells come from bf16 positions on both sides. The share of points whose corner cells differ
    between the frameworks is bounded by 1 % (measured: 0); on the other points the features agree
    to one bf16 unit of the largest feature (measured: bit for bit), and the table gradient, whose
    scatter-add sums duplicate rows in bf16 in another order, to 4 bf16 roundings of its largest
    entry (measured: 1 at d = 3 and 4)."""
    kw = dict(num_levels=5, min_res=16, max_res=512, log2_hashmap_size=10, features_per_level=2, n_input_dims=d)
    pos = np.random.RandomState(d).uniform(0.0, 1.0, (500, d)).astype(np.float32)
    cot = np.random.RandomState(10 + d).normal(size=(500, 10)).astype(np.float32)
    jmod = j_enc.HashEncoding(**kw, compute_dtype=jnp.bfloat16)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(pos)))
    want, vjp = jax.vjp(lambda p: jmod.apply(p, jnp.asarray(pos)), params)
    (want_grad,) = vjp(jnp.asarray(cot))
    want_grad = want_grad["params"]["hash_table"]
    tmod = t_enc.HashEncoding(**kw, compute_dtype=torch.bfloat16)
    load_jax_params(tmod, params["params"])
    got = tmod(torch.from_numpy(pos))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    (got_grad,) = torch.autograd.grad(got, [tmod.hash_table], torch.from_numpy(cot))

    # the corner cells of both sides: floor(bf16(p) * bf16(scaling)) per level
    scal_j = jnp.asarray(jmod.bind(params).scalings, jnp.bfloat16)
    base_j = np.asarray(jnp.floor(jnp.asarray(pos, jnp.bfloat16)[:, None, :] * scal_j[:, None]).astype(jnp.int32))
    scal_t = torch.tensor(tmod.scalings, dtype=torch.bfloat16)
    base_t = torch.floor(torch.from_numpy(pos).to(torch.bfloat16)[:, None, :] * scal_t[:, None]).long().numpy()
    same = (base_j == base_t).all(axis=(1, 2))
    print(f"bf16 hash grid d={d}: {1 - same.mean():.3%} of the points in other cells; features "
          f"{_err(got[torch.from_numpy(same)], np.asarray(want)[same]):.3g}, table gradient "
          f"{_err(got_grad, want_grad):.3g} of {float(np.abs(want_grad).max()):.3g}")
    assert same.mean() >= 0.99, f"{1 - same.mean():.3%} of the points sit in other cells"
    scale = float(np.abs(want).max())
    assert _err(got[torch.from_numpy(same)], np.asarray(want)[same]) <= 2 * BF16 * scale
    if same.all():
        assert _err(got_grad, want_grad) < 4 * BF16 * float(np.abs(want_grad).max())


# ---------------------------------------------------------------------------- (b) cast_hash_tables


def test_cast_hash_tables_only_touches_tables():
    """One cast per hash grid of the tree, from the float32 table and nothing else; the module's
    parameters stay float32; an encoder handed its cast table encodes as with its own cast."""
    from neuradar_tpu_torch.field_components.neurad_encoding import (
        ActorSettings,
        NeuRADHashEncodingConfig,
        StaticSettings,
    )

    grid = NeuRADHashEncodingConfig(static=StaticSettings(log2_hashmap_size=8, num_levels=2),
                                    actor=ActorSettings(log2_hashmap_size=6, num_levels=2))
    field = t_field.NeuRADField(t_field.NeuRADFieldConfig(grid=grid), 100.0, 2, torch.bfloat16)
    init_params(field, 0)
    tables = t_enc.cast_hash_tables(field, torch.bfloat16)
    grids = [m for m in field.modules() if isinstance(m, t_enc.HashEncoding)]
    assert set(tables) == set(grids) and len(grids) == 2
    for m in grids:
        assert tables[m].dtype == torch.bfloat16 and torch.equal(tables[m], m.hash_table.to(torch.bfloat16))
    assert all(p.dtype == torch.float32 for p in field.parameters())
    pos = torch.from_numpy(np.random.RandomState(0).uniform(size=(64, 3)).astype(np.float32))
    static = field.hashgrid.static_grid
    assert torch.equal(static(pos, tables), static(pos))
    # the JAX package's cast touches the same leaves: the hash tables alone
    params = {"hashgrid": {"static_grid": {"hash_table": jnp.ones(8)}, "actor_grid": {"hash_table": jnp.ones(8)}},
              "mlp_geo": {"output": {"kernel": jnp.ones((2, 2))}}}
    cast = j_enc.cast_hash_tables(params, jnp.bfloat16)
    changed = {"/".join(str(k.key) for k in path) for path, x in jax.tree_util.tree_leaves_with_path(cast)
               if x.dtype == jnp.bfloat16}
    names = {n for n, p in field.named_parameters() if any(p is m.hash_table for m in grids)}
    assert {c.replace("/", ".") for c in changed} == names


# ---------------------------------------------------------------------------- (c) radar decoder


def _radar_inputs():
    rng = np.random.RandomState(0)
    return rng.normal(size=(2, 70, 48)).astype(np.float32), rng.normal(0, 10, size=(2, 70, 3)).astype(np.float32)


def test_radar_decoder_bf16():
    """The transformer at bf16 (K2 at bf16: the JAX package's Pallas kernel in interpret mode, the
    port's plain version), dropout 0, heads in float32. Each output channel agrees to a tenth of a
    bf16 rounding of its largest value (measured: 1.2e-7 on the existence probability, float32
    noise) and to a tenth of what bf16 changes against the port's float32 decoder; the gradient of
    the features, through bf16 backward sums in other orders, to 4 bf16 roundings."""
    feats, geometry = _radar_inputs()
    cot = np.random.RandomState(1).normal(size=(2, 70, 7)).astype(np.float32)
    jmod = j_radar.RadarDecoder(d_model=48, dropout=0.0, attn_impl="pallas_interpret", dtype=jnp.bfloat16)
    params = _perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(geometry)))
    (want_out, want_ang), vjp = jax.vjp(lambda f: jmod.apply(params, f, jnp.asarray(geometry)), jnp.asarray(feats))
    (want_grad,) = vjp((jnp.asarray(cot), jnp.zeros_like(want_ang)))
    tmod = t_radar.RadarDecoder(d_model=48, dropout=0.0, dtype=torch.bfloat16)
    load_jax_params(tmod, params["params"])
    f = torch.from_numpy(feats).requires_grad_(True)
    got_out, got_ang = tmod(f, torch.from_numpy(geometry))
    assert got_out.dtype == got_ang.dtype == torch.float32
    (got_grad,) = torch.autograd.grad(got_out, [f], torch.from_numpy(cot))
    for layer in tmod.transformer.modules():
        if isinstance(layer, t_radar.TransformerEncoderLayer):
            layer.dtype = None
    f32_out, f32_ang = tmod(torch.from_numpy(feats), torch.from_numpy(geometry))
    want_out, want_ang = np.asarray(want_out), np.asarray(want_ang)
    for name, sl in (("existence", slice(0, 1)), ("xyz", slice(1, 4)), ("uncertainty", slice(4, 7))):
        g, w, r = got_out[..., sl], want_out[..., sl], f32_out[..., sl]
        scale = float(np.abs(w).max())
        assert _err(g, w) < 0.1 * BF16 * scale, name
        assert _err(g, w) < 0.1 * _err(r, w), name
    assert _err(got_ang, want_ang) < 0.1 * BF16 * float(np.abs(want_ang).max())
    assert _err(got_grad, want_grad) < 4 * BF16 * float(np.abs(np.asarray(want_grad)).max())


# ---------------------------------------------------------------------------- (d) VGG loss


def test_vgg_perceptual_loss_with_the_jax_filters():
    """VGGPerceptualLossPix2Pix with the JAX package's filters loaded (its seeded random ones, no
    .npz): the loss and its gradient in the prediction, float32 (rtol 1e-5: convolution sums in
    another order); no gradient reaches the target."""
    rng = np.random.RandomState(2)
    pred = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)  # 16 pixels: 1 x 1 after the four pools
    target = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    jmod = j_vgg.VGGPerceptualLossPix2Pix()
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(pred), jnp.asarray(target))
    want, want_grad = jax.value_and_grad(lambda p: jmod.apply(params, p, jnp.asarray(target)))(jnp.asarray(pred))
    tmod = t_vgg.VGGPerceptualLossPix2Pix()
    load_jax_params(tmod, params["params"])
    p, t = torch.from_numpy(pred).requires_grad_(True), torch.from_numpy(target).requires_grad_(True)
    got = tmod(p, t)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(_np(p.grad), np.asarray(want_grad), rtol=1e-4,
                               atol=1e-5 * float(np.abs(np.asarray(want_grad)).max()))
    assert t.grad is None
    assert tmod.weights == (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)

    # the model's tree carries the filters under vgg_loss/vgg19/conv*: they land in model.vgg_loss
    # (the rest of the model has no leaf in this partial tree, which the loader reports after loading)
    from neuradar_tpu_torch.model_components.dynamic_actors import trajectories_from_dicts
    from neuradar_tpu_torch.models.neuradar import NeuRadarModel, NeuRadarModelConfig, SceneMeta
    from tests.test_torch_slice import shrink

    cfg = NeuRadarModelConfig()
    shrink(cfg)
    model = NeuRadarModel(cfg, SceneMeta(), trajectories_from_dicts([]))
    with pytest.raises(ValueError, match="parameters without a flax leaf") as err:
        load_jax_params(model, {"vgg_loss": params["params"]})
    assert "vgg_loss" not in str(err.value)
    for name in tmod.vgg19.convs:
        assert torch.equal(getattr(model.vgg_loss.vgg19, name).weight, getattr(tmod.vgg19, name).weight)


def test_vgg_filters_are_frozen_and_keep_their_init():
    """The model's VGG filters are the trunk's own seeded ones (init_params leaves them), and the
    optimizer puts them in the "frozen" group."""
    from neuradar_tpu_torch.engine.optimizers import GroupedOptimizer, default_optimizer_groups
    from neuradar_tpu_torch.model_components.dynamic_actors import trajectories_from_dicts
    from neuradar_tpu_torch.models.neuradar import NeuRadarModel, NeuRadarModelConfig, SceneMeta
    from tests.test_torch_slice import shrink

    cfg = NeuRadarModelConfig()
    shrink(cfg)
    assert cfg.loss.vgg_mult == 0.05
    model = NeuRadarModel(cfg, SceneMeta(), trajectories_from_dicts([]))
    init_params(model, 0)
    ref = t_vgg.Vgg19Features(0)
    for name in ref.convs:
        assert torch.equal(getattr(model.vgg_loss.vgg19, name).weight, getattr(ref, name).weight)
    opt = GroupedOptimizer(model, default_optimizer_groups(10))
    vgg = {n: lab for n, lab in opt.labels.items() if n.startswith("vgg_loss.")}
    assert len(vgg) == 26 and set(vgg.values()) == {"frozen"}
    assert not any(p.requires_grad for p in model.vgg_loss.parameters())


# ---------------------------------------------------------------------------- (f) grouped radar decoding


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_radar_decoding_matches_ungrouped(dtype):
    """Dropout on (rate 0.1, the preset's), 4 scans decoded in 1, 2 and 4 groups, each group
    recomputed in the backward pass. The draws are made for all scans first and K2's mask hashes
    the global scan index, so every group drops what the whole batch drops, and the transformer's
    output is equal bit for bit. The heads' outputs and the features' gradient are held to 2
    float32 units of their largest value: torch's CPU sigmoid and softplus round the vectorized
    body and the tail of a tensor differently, so the same row can differ in its last bit in a
    tensor of another size (measured: 6e-8 on outputs up to 30). A parameter's gradient sums over
    all scans, per group and then across groups: float32 to 1e-6 of its largest entry or of 1,
    whichever is larger (measured: 4e-7; the key bias's exact gradient is 0); in bf16 each group's
    sum is rounded to bf16 before they add up, so to 2 bf16 units (measured: one)."""
    from neuradar_tpu_torch.model_components.dynamic_actors import trajectories_from_dicts
    from neuradar_tpu_torch.models.neuradar import NeuRadarModel, NeuRadarModelConfig, SceneMeta
    from neuradar_tpu_torch.ops.attention import batch_offset_seed, keep_mask
    from tests.test_torch_slice import shrink

    cfg = NeuRadarModelConfig(compute_dtype=dtype)
    shrink(cfg)
    cfg.loss.vgg_mult = 0.0
    model = NeuRadarModel(cfg, SceneMeta(), trajectories_from_dicts([]))
    init_params(model, 1)
    decoder = model.radar_decoder
    rng = np.random.RandomState(3)
    feats = torch.from_numpy(rng.normal(size=(4, 40, 48)).astype(np.float32))
    geometry = torch.from_numpy(rng.normal(0, 10, size=(4, 40, 3)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(4, 40, 7)).astype(np.float32))

    # the groups' draws are the whole batch's, and so are K2's masks
    noise = decoder.draw_noise(4, 40, torch.Generator().manual_seed(11), "cpu")
    seed = noise[0]["seed"]
    pos = t_radar.sine_position_embedding(geometry, 48)
    with torch.no_grad():
        whole = decoder.transformer(feats, pos, noise)
        for g in (1, 2):
            parts = []
            for i in range(0, 4, g):
                part = decoder.slice_noise(noise, i, i + g)
                assert torch.equal(keep_mask(part[0]["seed"], g, 40, 0.1), keep_mask(seed, 4, 40, 0.1)[i:i + g])
                assert part[0]["seed"] == batch_offset_seed(seed, i)
                parts.append(decoder.transformer(feats[i:i + g], pos[i:i + g], part))
            assert torch.equal(torch.cat(parts), whole), g
        assert not torch.equal(decoder.transformer(feats, pos, None), whole)  # dropout was on

    runs = []
    for groups in (1, 2, 4):
        cfg.radar_decode_chunks = groups
        model.zero_grad()
        f = feats.clone().requires_grad_(True)
        out, ang = model.decode_radar(f, geometry, torch.Generator().manual_seed(11))
        out.backward(cot)
        runs.append((out.detach(), ang.detach(), f.grad,
                     *[p.grad.clone() for p in decoder.parameters() if p.grad is not None]))
    param_rtol = 1e-6 if dtype == "float32" else 2 * BF16
    for other in runs[1:]:
        assert len(other) == len(runs[0])
        for i, (a, b) in enumerate(zip(other, runs[0])):
            rel = 2 * 2.0**-23 if i < 3 else param_rtol
            torch.testing.assert_close(a, b, rtol=0, atol=rel * max(float(b.abs().max()), 1.0 if i >= 3 else 0.0))


# ---------------------------------------------------------------------------- the benchmark program


def test_bench_program_matches_the_jax_package():
    """Every rung's batch, the production knobs of the full program (bf16, 8 chunks, the hoisted
    cast, 4 radar groups, no VGG loss) and the bench scene, against the JAX package's
    configs/bench_program.py; the options that wait for K4 raise."""
    from neuradar_tpu.configs import bench_program as j_bench
    from neuradar_tpu_torch.configs import bench_program as t_bench

    for scale in ("full", "half", "three8", "quarter", "eighth", "micro"):
        want, got = j_bench.bench_datamanager_config(scale), t_bench.bench_datamanager_config(scale)
        for key in ("num_rgb_patches", "patch_size", "num_lidar_rays", "num_radar_scans", "max_radar_gt"):
            assert getattr(got, key) == getattr(want, key), (scale, key)
    jcfg = j_bench.bench_pipeline("micro", chunks=8).config.model
    tcfg = t_bench.bench_pipeline_config("micro", chunks=8).model
    for key in ("compute_dtype", "nff_chunks", "hoist_table_cast", "radar_decode_chunks"):
        assert getattr(tcfg, key) == getattr(jcfg, key), key
    assert tcfg.loss.vgg_mult == jcfg.loss.vgg_mult == 0.0
    other = t_bench.bench_pipeline_config(hoist=False, radar_chunks=2).model
    assert other.radar_decode_chunks == 2 and other.hoist_table_cast is False
    for kw in (dict(remat_policy="save_grid"), dict(packed_cells=True)):
        with pytest.raises(NotImplementedError, match="K4"):
            t_bench.bench_pipeline_config(**kw)
    want, got = j_bench.bench_scene_outputs(), t_bench.bench_scene_outputs()
    assert got.image_size == tuple(want.image_size) == (96, 156) and len(got.images) == len(want.images) == 24
    np.testing.assert_array_equal(got.images[5], want.images[5])
    np.testing.assert_array_equal(got.lidar_points[3], want.lidar_points[3])
