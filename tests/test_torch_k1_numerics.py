"""The order in which K1's backward kernel (csrc/composite_sky.cu) rounds, emulated on the CPU.

The kernel takes every per-sample scalar with lane = sample, 32 samples at a time: the
exclusive transmittance is a Hillis-Steele product scan over the lanes (the next 32 samples
carried on the running product), accum a per-lane sum over the chunks and then an xor-butterfly
warp sum, and the suffix sum_{k>i} dw[k] w[k] a reverse Hillis-Steele sum scan (earlier chunks
carried on the later chunks' totals). The float4 path (S <= 64, C a multiple of 4 up to 128)
sums each row's dot product with df as ((x0 d0 + x1 d1) + x2 d2) + x3 d3 per float4 and then an
xor butterfly over the row's L lanes; the general path sums channel c = lane + 32 k in k order
per lane and then over the warp. Every operation here rounds to float32 as an IEEE operation
would; the card may fuse a multiply and an add (FMA), which rounds once where this rounds twice.
The emulation lives here only; no path of the port runs it.

It is held against float64 and against the float32 plain version (autograd through cumprod) at
K1_BWD_TOL, the tolerance chip_smoke.py holds the kernel to at the train shape. The margin is
max |err| / (atol + rtol |want|) against float64, for dalpha and dfeats: at S = 1, 0 % and 0.1 %;
at S = 33, 7.3 % and 4.8 % (C = 32) and 7.6 % and 6.3 % (C = 40); at S = 768, 2.4 % and 3.2 %.
The float32 plain version lands at 1.9 % and 0.1 %, 6.7 % and 5.2 %, 5.7 % and 5.3 %, 2.1 % and
4.5 % on the same inputs, so the scans cost no accuracy; the test asks for under 10 %.
"""

import numpy as np
import pytest
import torch

from neuradar_tpu_torch.ops import volumetric as t_volumetric

K1_BWD_TOL = dict(rtol=1e-4, atol=1e-5)  # chip_smoke.py's
EPS = 1e-7
LANES = 32


def _shift_up(x, off, fill):
    """Lane l reads lane l - off (``__shfl_up_sync``); lanes below ``off`` read ``fill``."""
    return torch.cat([torch.full_like(x[..., :off], fill), x[..., :-off]], dim=-1)


def _shift_down(x, off, fill):
    """Lane l reads lane l + off (``__shfl_down_sync``); lanes past 31 - ``off`` read ``fill``."""
    return torch.cat([x[..., off:], torch.full_like(x[..., :off], fill)], dim=-1)


def _xor_sum(x, width):
    """``for off = width/2 .. 1: x += shfl_xor(x, off)`` over groups of ``width`` lanes (last axis)."""
    lane = torch.arange(x.shape[-1])
    off = width // 2
    while off:
        x = x + x[..., lane ^ off]
        off //= 2
    return x


def _scan_mul(x):
    """Inclusive Hillis-Steele product scan over the lanes."""
    off = 1
    while off < LANES:
        x = x * _shift_up(x, off, 1.0)
        off *= 2
    return x


def _rscan_add(x):
    """Inclusive Hillis-Steele sum over lanes l..31 (adding 0 past the end leaves a lane as it is)."""
    off = 1
    while off < LANES:
        x = x + _shift_down(x, off, 0.0)
        off *= 2
    return x


def _row_dots(feats, df, path):
    """sum_c feats[r, s, c] df[r, c] in the kernel's order: [R, S]."""
    R, S, C = feats.shape
    prod = feats * df[:, None, :]
    if path == "float4":
        L = 1
        while L < C // 4:
            L *= 2
        q = prod.reshape(R, S, C // 4, 4)
        v = ((q[..., 0] + q[..., 1]) + q[..., 2]) + q[..., 3]
        v = torch.cat([v, v.new_zeros(R, S, L - C // 4)], dim=-1)
        return _xor_sum(v, L)[..., 0]
    K = -(-C // LANES)
    p = torch.cat([prod, prod.new_zeros(R, S, K * LANES - C)], dim=-1).reshape(R, S, K, LANES)
    part = torch.zeros(R, S, LANES)
    for k in range(K):
        part = part + p[:, :, k]
    return _xor_sum(part, LANES)[..., 0]


def k1_bwd_emulated(alpha, feats, dwsky, df, daccum, path):
    """K1 backward in float32, rounding in the kernel's order (see the module's note)."""
    R, S = alpha.shape
    n = -(-S // LANES)
    pad = n * LANES - S
    valid = torch.arange(n * LANES) < S
    a = torch.cat([alpha, alpha.new_zeros(R, pad)], -1).reshape(R, n, LANES)
    om = 1.0 - a + EPS
    T, carry, acc = [], torch.ones(R, 1), torch.zeros(R, LANES)
    for c in range(n):
        inc = _scan_mul(om[:, c])
        t = carry * _shift_up(inc, 1, 1.0)
        T.append(t)
        acc = acc + a[:, c] * t
        carry = carry * inc[:, -1:]
    T = torch.stack(T, 1)
    acc = _xor_sum(acc, LANES)[:, :1]
    w = a * T
    w_flat = w.reshape(R, -1)[:, :S]
    w_sky = torch.cat([w_flat[:, :-1], (w_flat[:, -1:] + 1.0) - acc], dim=-1)
    dfeats = w_sky[..., None] * df[:, None, :]

    G = dwsky + _row_dots(feats, df, path)
    dw = torch.cat([G[:, :-1] - G[:, -1:], torch.zeros(R, 1)], dim=-1) + daccum
    dw = torch.cat([dw, dw.new_zeros(R, pad)], -1).reshape(R, n, LANES)
    gg = torch.where(valid.reshape(n, LANES), dw * w, torch.zeros(()))
    out, carry_s = [None] * n, torch.zeros(R, 1)
    for c in reversed(range(n)):
        inc = _rscan_add(gg[:, c])
        su = _shift_down(inc, 1, 0.0) + carry_s
        out[c] = dw[:, c] * T[:, c] - su / om[:, c]
        carry_s = carry_s + inc[:, :1]
    dalpha = torch.stack(out, 1).reshape(R, -1)[:, :S]
    return dalpha, dfeats


def _inputs(R, S, C, seed=0):
    rng = np.random.RandomState(seed)
    alpha = rng.uniform(0.0, 0.95, (R, S)).astype(np.float32)
    feats = rng.normal(size=(R, S, C)).astype(np.float32)
    cots = (rng.normal(size=(R, S)), rng.normal(size=(R, C)), rng.normal(size=(R, 1)))
    return tuple(torch.from_numpy(np.asarray(x, np.float32)) for x in (alpha, feats, *cots))


def _margin(got, want, tol) -> float:
    return float(((got.double() - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())).max())


@pytest.mark.parametrize("S,C,path", [(1, 32, "float4"), (33, 32, "float4"), (33, 40, "float4"),
                                      (768, 32, "general")])
def test_kernel_order_within_tolerance(S, C, path):
    inputs = _inputs(256 if S < 768 else 48, S, C)
    got = k1_bwd_emulated(*inputs, path)
    want64 = t_volumetric.composite_sky_bwd_reference(*(x.double() for x in inputs))
    want32 = t_volumetric.composite_sky_bwd_reference(*inputs)
    for g, w64, w32, name in zip(got, want64, want32, ("dalpha", "dfeats")):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g.double(), w64, **K1_BWD_TOL, msg=lambda m: f"{name} vs float64: {m}")
        torch.testing.assert_close(g, w32, **K1_BWD_TOL, msg=lambda m: f"{name} vs float32 plain: {m}")
        assert _margin(g, w64, K1_BWD_TOL) < 0.1, name


def test_warp_sum_gives_every_lane_the_same_bits():
    """The kernel relies on it: every lane holds the same accum, so every lane's w_sky of the last
    sample, and the dfeats row it writes, agree."""
    x = torch.from_numpy(np.random.RandomState(1).normal(size=(500, LANES)).astype(np.float32))
    total = _xor_sum(x, LANES)
    assert torch.equal(total, total[:, :1].expand_as(total))
