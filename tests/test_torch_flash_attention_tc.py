"""The numerics of the bf16 tensor-core flash-attention kernel, emulated in
PyTorch on the CPU, and the launcher's choice of kernel.

The kernel (csrc/flash_attention.cu, `flash_fwd_tc`) computes S = Q.K^T
from bf16 operands with fp32 sums, the softcap with an accurate tanh, an
fp32 online softmax over 64-key tiles (exp as exp2((x - m) log2 e)), and
P.V with fp32 P split as P_hi = bf16(P), P_lo = bf16(P - P_hi), each
multiplied by bf16 V with fp32 sums.  `tc_emulation` follows those steps
tile by tile.  It is held to the card's tolerance: within 1e-5 beyond one
bf16 rounding of the plain blockwise version's fp32 result (`bf16_excess`,
as chip_smoke.py and tests/test_torch_flash_attention_cuda.py measure the
kernel).  The same emulation with P as one bf16 term, or with P rounded to
TF32, lies well beyond that tolerance: two terms are the design."""
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel, ref  # noqa: E402

BF16_ATOL = 1e-5
NEG_INF = -2.0e38
LOG2E = 1.4426950408889634


def bf16_excess(out, exact):
    """max(|out - exact| - half a bf16 ulp of exact)."""
    x = exact.float()
    _, e = torch.frexp(x)
    half_ulp = torch.where(x == 0, torch.zeros_like(x),
                           torch.ldexp(torch.ones_like(x), e - 9))
    return float(((out.float() - x).abs() - half_ulp).max())


def tf32(x):
    """x rounded to 10 mantissa bits, to nearest (ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tc_emulation(q, k, v, *, window, cap, scale, p_terms="split",
                 bq=128, bk=64):
    """The tensor-core kernel's arithmetic on bf16 q (B,S,H,hd), k
    (B,T,G,hd), v (B,T,G,hd_v); returns bf16 (B,S,H,hd_v).  p_terms: "split" (P_hi + P_lo,
    the kernel), "hi" (one bf16 term) or "tf32" (P rounded to TF32)."""
    B, S, H, hd = q.shape
    T, hdv = k.shape[1], v.shape[3]
    qf = q.float().transpose(1, 2)                                # B,H,S,hd
    kf = ref.expand_kv(k, H).float().transpose(1, 2)
    vf = ref.expand_kv(v, H).float().transpose(1, 2)
    out = torch.empty((B, H, S, hdv), dtype=torch.float32)
    for q0 in range(0, S, bq):
        rows = torch.arange(q0, min(q0 + bq, S))
        m = torch.full((B, H, len(rows)), NEG_INF)
        l = torch.zeros((B, H, len(rows)))
        o = torch.zeros((B, H, len(rows), hdv))
        k_first = max(0, q0 - window + 1) if window else 0
        k_end = min(int(rows[-1]) + 1, T)
        for k0 in range((k_first // bk) * bk, k_end, bk):
            keys = torch.arange(k0, min(k0 + bk, T))
            x = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2) * scale
            if cap:
                x = cap * torch.tanh(x / cap)
            ok = keys[None, :] <= rows[:, None]
            if window:
                ok &= (rows[:, None] - keys[None, :]) < window
            x = torch.where(ok, x, torch.tensor(NEG_INF))
            mx = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2((m - mx) * LOG2E)
            p = torch.where(x == NEG_INF, torch.zeros_like(x),
                            torch.exp2((x - mx[..., None]) * LOG2E))
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None]
            m = mx
            hi = p.bfloat16().float()
            if p_terms == "split":
                lo = (p - hi).bfloat16().float()
                o = o + hi @ vf[:, :, keys] + lo @ vf[:, :, keys]
            elif p_terms == "hi":
                o = o + hi @ vf[:, :, keys]
            else:
                o = o + tf32(p) @ vf[:, :, keys]
        out[:, :, rows] = o / torch.clamp(l, min=1e-37)[..., None]
    return out.transpose(1, 2).bfloat16()


def _case(B, S, H, G, hd, seed, hdv=None):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .bfloat16() for shape in ((B, S, H, hd), (B, S, G, hd),
                                      (B, S, G, hdv or hd))]


def _excess(hd, S, window, cap, p_terms, seed=0, hdv=None):
    q, k, v = _case(1, S, 4, 2, hd, seed, hdv)
    out = tc_emulation(q, k, v, window=window, cap=cap, scale=hd ** -0.5,
                       p_terms=p_terms)
    exact = ref.flash_attention_blockwise(q.float(), k.float(), v.float(),
                                          window=window, logit_softcap=cap,
                                          scale=hd ** -0.5)
    return bf16_excess(out, exact)


@pytest.mark.parametrize("hd,S,window,cap", [
    (32, 203, None, 0.0),      # ragged S
    (32, 203, 50, 50.0),       # window inside one key tile's reach
    (80, 320, None, 0.0),      # zamba2's head dim
    (80, 203, 16, 30.0),       # window smaller than a key tile
    (256, 203, None, 50.0),    # gemma2's head dim and softcap, global
    (256, 256, 100, 50.0),     # gemma2's, windowed
])
def test_split_p_emulation_within_bf16_tolerance(hd, S, window, cap):
    """The kernel's design lies within BF16_ATOL of one rounding of the
    plain version's fp32 result."""
    assert _excess(hd, S, window, cap, "split") <= BF16_ATOL


@pytest.mark.parametrize("p_terms", ["hi", "tf32"])
@pytest.mark.parametrize("hd,S,window,cap", [(256, 256, None, 50.0),
                                             (80, 320, None, 0.0)])
def test_one_term_p_exceeds_the_tolerance(p_terms, hd, S, window, cap):
    """P as a single bf16 term, or rounded to TF32, is held to the same
    tolerance and fails it by more than an order of magnitude."""
    assert _excess(hd, S, window, cap, p_terms) > 10 * BF16_ATOL


@pytest.mark.parametrize("hd", kernel.HEAD_DIMS)
def test_route_by_dtype(hd):
    """bf16 always takes the tensor-core kernel, fp32 the CUDA-core one;
    both fit the 227 KB a block may have, and the bf16 tiles are whole
    warpgroups (64 rows) over whole 16-key k-steps."""
    tc = kernel.route(torch.bfloat16, hd)
    cc = kernel.route(torch.float32, hd)
    assert kernel.ROUTES[tc.route].startswith("bf16 tensor cores")
    assert kernel.ROUTES[cc.route].startswith("fp32 CUDA cores")
    assert tc.q_rows % 64 == 0 and tc.threads == 2 * tc.q_rows
    assert tc.k_rows % 16 == 0 and tc.kv_stages >= 2
    for r in (tc, cc):
        assert r.smem_bytes <= 232448


def test_route_refuses_other_types_and_head_dims():
    with pytest.raises(TypeError):
        kernel.route(torch.float16, 64)
    with pytest.raises(ValueError):
        kernel.route(torch.bfloat16, 96)
    for hd, hd_v in ((192, 192), (128, 192), (192, 64), (256, 128),
                     (128, 64)):
        with pytest.raises(ValueError):
            kernel.route(torch.bfloat16, hd, hd_v)


# ---------------------------------------------------------------------------
# q/k head dim 192 with v head dim 128 (DeepSeek-V2's MLA)
# ---------------------------------------------------------------------------


def test_route_of_the_mla_pair():
    """bf16: Q and K in 3 panels of 64, V in 2 (not padded to 3): 48 KB of
    Q + 2 stages x (24 KB of K + 16 KB of V) + 1 KB; fp32: V rows of 128
    floats beside Q and K rows of 196."""
    assert kernel.route(torch.bfloat16, 192, 128) == kernel.Route(
        1, 128, 64, 2, 256, 3 * 128 * 128 + 2 * (3 + 2) * 64 * 128 + 1024)
    assert kernel.route(torch.bfloat16, 192, 128).smem_bytes == 132096
    assert kernel.route(torch.float32, 192, 128) == kernel.Route(
        0, 64, 32, 1, 256, 4 * (64 * 196 + 32 * 196 + 32 * 128))
    assert kernel.route(torch.bfloat16, 128) == kernel.route(
        torch.bfloat16, 128, 128)


@pytest.mark.parametrize("hd,hd_v", [(192, 192), (192, 64), (128, 64),
                                     (256, 128)])
def test_launcher_refuses_other_mixed_pairs_before_any_cuda_call(hd, hd_v):
    q = torch.zeros((1, 8, 2, hd))
    k = torch.zeros((1, 8, 2, hd))
    v = torch.zeros((1, 8, 2, hd_v))
    with mock.patch.object(kernel._build, "library",
                           side_effect=AssertionError("built")):
        with pytest.raises(ValueError, match="head dims"):
            kernel.flash_attention_cuda(q, k, v, scale=1.0)


def test_launcher_refuses_cpu_tensors_before_any_cuda_call():
    q, k = torch.zeros((1, 8, 2, 192)), torch.zeros((1, 8, 2, 192))
    v = torch.zeros((1, 8, 2, 128))
    with mock.patch.object(kernel._build, "library",
                           side_effect=AssertionError("built")):
        with pytest.raises(ValueError, match="CUDA device"):
            kernel.flash_attention_cuda(q, k, v, scale=1.0)


def test_mla_pair_plain_version_matches_jax_blockwise():
    """The plain blockwise version at q/k 192, v 128 against the JAX
    model's blockwise `flash_attention` (which takes expanded K/V), fp32,
    within 1e-5; the output has v's head dim."""
    jax = pytest.importorskip("jax")
    from repro.models.attention import flash_attention as jflash
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 70, 4, 192)).astype(np.float32)
    k = rng.standard_normal((2, 70, 4, 192)).astype(np.float32)
    v = rng.standard_normal((2, 70, 4, 128)).astype(np.float32)
    out = ref.flash_attention_blockwise(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=192 ** -0.5, q_block=16, kv_block=16)
    jout = jax.jit(lambda q, k, v: jflash(q, k, v, scale=192 ** -0.5,
                                          q_block=16, kv_block=16))(q, k, v)
    assert out.shape == (2, 70, 4, 128)
    assert float(np.abs(out.numpy() - np.asarray(jout)).max()) < 1e-5


@pytest.mark.parametrize("S,window,cap", [(203, None, 0.0), (256, 100, 50.0)])
def test_split_p_emulation_at_the_mla_pair(S, window, cap):
    """The tensor-core kernel's design at q/k 192, v 128 lies within
    BF16_ATOL of one rounding of the plain version's fp32 result."""
    assert _excess(192, S, window, cap, "split", hdv=128) <= BF16_ATOL
