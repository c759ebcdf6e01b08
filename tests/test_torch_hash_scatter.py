"""The hash tables' gradient scatter of the plain path (K4's backward, ``ops/hash_scatter.py``).

On the CPU an encode's ``_CornerGather`` gives the forward, the table's gradient and the positions'
gradient of plain autograd through one ``table[idx]`` a corner, bit for bit, at every grid shape the
presets use (d 3 or 4, F 1, 2 or 4, float32 or bf16 tables). The card's kernel, which recomputes the
corners and adds the same contributions, is held against the float64 sum in
``tests/test_torch_hash_encode.py``.
"""

import pytest
import torch

from neuradar_tpu_torch.field_components import encodings
from neuradar_tpu_torch.ops import hash_encode as t_encode
from neuradar_tpu_torch.ops import hash_scatter as t_scatter

DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["float32", "bf16"]


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
    """A bf16 table's levels go into the encode's backward launches of at most SCRATCH_FLOATS float32
    values (at least one level); a float32 table accumulates in its gradient in one launch. The neuradar
    preset's grids: the field's static 8 x 2^22 x 4 one level a launch, the others whole."""
    per = t_encode.levels_per_launch
    assert per(2**22, 4, 8, torch.bfloat16) == 1
    assert per(2**17, 4, 4, torch.bfloat16) == 4
    assert per(2**20, 1, 6, torch.bfloat16) == 6
    assert per(2**15, 1, 4, torch.bfloat16) == 4
    assert per(2**22, 4, 8, torch.float32) == 8
    assert per(2**23, 4, 8, torch.bfloat16) == 1


def test_hash_scatter_cpu_runs_plain_version():
    """On the CPU an encode's backward is the plain version and launches no kernel; the plain
    version keeps to ``float64_sum``'s bound."""
    gen = torch.Generator().manual_seed(3)
    grads = [torch.randn((50, 2, 3), generator=gen) for _ in range(8)]
    idxs = [torch.randint(0, 16, (50, 2), generator=gen) + torch.tensor([0, 16]) for _ in range(8)]
    before = (t_encode.hash_encode_fwd.launches, t_encode.hash_encode_bwd.launches)
    enc, positions, weights = _encoder(3, 2, torch.float32)
    _encode_grads(enc, positions, weights)
    got = t_scatter.hash_scatter_reference(grads, idxs, (32, 3))
    assert (t_encode.hash_encode_fwd.launches, t_encode.hash_encode_bwd.launches) == before
    exact, bound = t_scatter.float64_sum(grads, idxs, (32, 3))
    assert bool(((got.double() - exact).abs() <= bound).all()) and float(bound.max()) > 0
