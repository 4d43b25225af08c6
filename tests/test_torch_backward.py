"""The plain backward versions of the port's two kernel ops on the CPU
against JAX's gradients of the JAX package's references:
``attention_bwd_ref`` against ``jax.vjp`` of ``attention_ref`` (GQA
groups 1, 3 and 4, causal and full, Sq < Sk, S of 1 and 33, f32 and
bf16) and ``selective_scan_bwd_ref`` against ``jax.vjp`` of
``selective_scan_ref`` (with and without a gradient of the final state;
S of 1 and 33).  These plain versions are what the hand-written backward
kernels are held to on the card.

Inputs come from a numpy seed.  Tolerances: f32 gradients within 2e-5
(attention) and 5e-5 (the scan: the reverse-time sums run in another
order) of the largest gradient element, relative; bf16 attention
gradients, computed in f32 on both sides and rounded to bf16 at the end,
within two bf16 steps (2^-7) of the largest element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.ssm_scan.ref import selective_scan_ref
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
from repro_torch.kernels.ssm_scan.ref import selective_scan_bwd_ref

REL = {"float32": 2e-5, "bfloat16": 2**-7}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _to_torch(a, dtype):
    return torch.from_numpy(a).to(TORCH[dtype])


def _close(got, want, rel):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    bound = rel * max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= bound


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", [
    (2, 4, 4, 33, 33, 16, True),    # group 1
    (2, 9, 3, 33, 33, 64, True),    # group 3 (smollm-135m's 9:3)
    (1, 8, 2, 33, 33, 32, False),   # group 4, full
    (2, 4, 1, 17, 40, 16, True),    # Sq < Sk, end-aligned
    (1, 6, 2, 12, 33, 32, False),   # Sq < Sk, full
    (2, 4, 4, 1, 33, 16, True),     # one query row
    (1, 3, 3, 1, 1, 16, True),      # S of 1
])
def test_attention_bwd_ref_matches_jax_vjp(dtype, b, hq, hkv, sq, sk, d, causal):
    rng = np.random.default_rng(hq * 100 + sq)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d), (b, hq, sq, d)))
    jargs = [jnp.asarray(a, JNP[dtype]) for a in (q, k, v)]
    _, vjp = jax.vjp(lambda q_, k_, v_: attention_ref(q_, k_, v_, causal=causal), *jargs)
    want = vjp(jnp.asarray(do, JNP[dtype]))
    got = attention_bwd_ref(*(_to_torch(a, dtype) for a in (q, k, v, do)), causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == TORCH[dtype]
        _close(g, w, REL[dtype])


def _scan_inputs(rng, b, s, d, n):
    dt = np.log1p(np.exp(rng.standard_normal((b, s, d)) - 1.0)).astype(np.float32)  # softplus
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal((d, n))).astype(np.float32)
    h0 = rng.standard_normal((b, d, n)).astype(np.float32)
    return dt, bm, cm, x, a, h0


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("b,s,d,n", [(2, 33, 24, 8), (1, 1, 16, 4), (3, 33, 7, 16), (2, 5, 33, 1)])
def test_selective_scan_bwd_ref_matches_jax_vjp(b, s, d, n, with_dh):
    rng = np.random.default_rng(s * 10 + n)
    args = _scan_inputs(rng, b, s, d, n)
    dy = rng.standard_normal((b, s, d)).astype(np.float32)
    dh = rng.standard_normal((b, d, n)).astype(np.float32) if with_dh else np.zeros((b, d, n),
                                                                                    np.float32)
    _, vjp = jax.vjp(selective_scan_ref, *(jnp.asarray(a) for a in args))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    got = selective_scan_bwd_ref(*(torch.from_numpy(a) for a in args), torch.from_numpy(dy),
                                 torch.from_numpy(dh) if with_dh else None)
    for name, g, w in zip(("dt", "B", "C", "x", "A", "h0"), got, want):
        assert g.dtype == torch.float32, name
        _close(g, w, 5e-5)
