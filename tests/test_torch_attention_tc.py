"""Why K2's CUDA kernels split every float32 operand in two before the tensor cores (3xTF32).

``csrc/attention.cu`` runs its S*S*D products as ``mma.sync`` in TF32, which keeps 10 of
float32's 23 mantissa bits. Each operand x goes in as big = rna(x) and small = rna(x - big)
(rna: round to nearest, ties away from zero, as ``cvt.rna.tf32.f32``), and a product is
small_a big_b + big_a small_b + big_a big_b, summed in float32. These tests emulate that scheme,
and a single TF32 product, in plain torch on the CPU, through K2's forward (scores in log2 units
with exp2, as the kernel) and through one backward product (dQ = D^-1/2 dS K), and hold them
against float64: the split lands inside the tolerances the kernel tests use, one TF32 product
alone does not. The emulation lives here only; no path of the port runs it.
"""

import numpy as np
import pytest
import torch

from neuradar_tpu_torch.ops import attention as t_attention

K2_TOL = dict(rtol=1e-4, atol=1e-5)  # as tests/test_torch_ops.py
K2_BWD_TOL = dict(rtol=2e-4, atol=2e-5)
LOG2E = 1.4426950408889634
SEED = 3


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value, ties away from zero: add half of the 13 dropped bits'
    range to the magnitude's bits, then clear them (the int32 view keeps the sign bit apart)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def matmul_1xtf32(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def matmul_3xtf32(a, b):
    a_big, b_big = tf32_rna(a), tf32_rna(b)
    a_small, b_small = tf32_rna(a - a_big), tf32_rna(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _inputs(B=2, S=300, D=48):
    rng = np.random.RandomState(1)
    return tuple(torch.from_numpy(rng.normal(size=(B, S, D)).astype(np.float32)) for _ in range(4))


def attention_emulated(q, k, v, matmul, rate):
    """K2 forward as the kernel computes it, with ``matmul`` for its two products, in float32."""
    D = q.shape[-1]
    s = matmul(q * (D**-0.5 * LOG2E), k.transpose(1, 2))
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)  # every key, dropped or not
    if rate > 0.0:
        p = p * t_attention.keep_mask(SEED, q.shape[0], q.shape[1], rate) * np.float32(1.0 / (1.0 - rate))
    return matmul(p, v) / l


def _fails(got, want, tol) -> bool:
    return not torch.allclose(got.double(), want, **tol)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one_ulp = 2.0**-10  # TF32's spacing in [1, 2)
    x = torch.tensor([1.0, 1.0 + 0.49 * one_ulp, 1.0 + 0.5 * one_ulp, -(1.0 + 0.5 * one_ulp), 1.0 + 0.51 * one_ulp,
                      3.0e-3], dtype=torch.float32)
    got = tf32_rna(x)
    want = torch.tensor([1.0, 1.0, 1.0 + one_ulp, -(1.0 + one_ulp), 1.0 + one_ulp, 0.0], dtype=torch.float64)
    want[5] = float(np.round(3.0e-3 * 2.0**19) / 2.0**19)  # 3e-3 lies in [2^-9, 2^-8): spacing 2^-19
    torch.testing.assert_close(got.double(), want, rtol=0, atol=0)
    assert torch.equal(tf32_rna(got), got)
    assert torch.all(got.view(torch.int32) & 0x1FFF == 0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_forward_3xtf32_within_tolerance_single_tf32_not(rate):
    q, k, v, _ = _inputs()
    want = t_attention.attention_reference(q.double(), k.double(), v.double(), SEED, rate)
    got = attention_emulated(q, k, v, matmul_3xtf32, rate)
    torch.testing.assert_close(got.double(), want, **K2_TOL)
    assert _fails(attention_emulated(q, k, v, matmul_1xtf32, rate), want, K2_TOL)


def test_backward_product_3xtf32_within_tolerance_single_tf32_not():
    q, k, v, dout = _inputs()
    D = q.shape[-1]
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, dout))
    p = torch.softmax(q64 @ k64.transpose(1, 2) * D**-0.5, dim=-1)
    dp = do64 @ v64.transpose(1, 2)
    ds = (p * (dp - (do64 * (p @ v64)).sum(-1, keepdim=True))).float()  # dS as the kernel holds it
    want = D**-0.5 * (ds.double() @ k64)
    torch.testing.assert_close((D**-0.5 * matmul_3xtf32(ds, k)).double(), want, **K2_BWD_TOL)
    assert _fails(D**-0.5 * matmul_1xtf32(ds, k), want, K2_BWD_TOL)
