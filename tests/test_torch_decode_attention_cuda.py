"""The CUDA decode-attention kernel against its plain version, on the card.

Needs an NVIDIA Hopper card and nvcc: the kernel has no CPU mode, so these
tests skip elsewhere.  Run on the card with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_decode_attention_cuda.py``.
This file imports no JAX, so it runs where JAX is not installed.

Each output is held against the exact function, computed in fp64 from the
same operands (q rounded to the cache's type; p rounded to the cache's type
from its fp64 value), and against the plain version run on the card.  The
allowance an element has beyond one rounding of the output (`_exact`):
  * 1e-5 of sum_t p_t |v_t|, the scale of its sums: the kernel sums q.k in
    fp32 over at most 256 products and p.v over at most 4097 keys, in
    another order than the plain version; each fp32 sum is off by a few
    units of 2^-24 relative, and a score's error moves p by as much
    relative;
  * for a bf16 cache, one bf16 ulp of p_t times |v_t| at each key whose p
    lies within 1e-5 relative of a rounding boundary of bf16: there the
    fp32 p of either order may round to the other neighbour.  Away from
    the boundaries both round p alike, so a missing or extra rounding of p
    shows (the fp32-output case below sees it, where the output's own
    rounding does not hide it)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import kernel, ops, ref  # noqa: E402

# (Hq_pad, G): deepseek-7b and zamba2, whisper's decoder, gemma2-2b,
# qwen2-vl-2b, qwen2.5-32b, deepseek-67b and arctic-480b
HEADS = [(32, 32), (16, 8), (16, 4), (16, 2), (48, 8), (64, 8)]
# (window, softcap): none; gemma2-2b's 4096 and 50, which excludes key 0 at
# the last position of 4097; a window that starts inside a chunk
MASKS = [(None, 0.0), (4096, 50.0), (37, 0.0)]
T = 4097          # the served cache: 4080-token prompts and 16 new + 1
EPS = 1e-5


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _positions(b, g, m):
    """Ragged positions: 0, a chunk's last key and the next chunk's first,
    T - 1 and others (one row: T - 1)."""
    if b == 1:
        return torch.tensor([T - 1], device="cuda")
    c = kernel.plan(b, g, m, T).chunk
    return torch.tensor([0, c - 1, c, T - 1, T // 2, 1, 2 * c + 5, T - 2],
                        device="cuda")


def _inputs(b, hq, g, hd, dt, seed):
    gen = torch.Generator("cuda").manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    return draw(b, 1, hq, hd), draw(b, T, g, hd), draw(b, T, g, hd)


def _exact(q, kc, vc, pos, window, cap, scale):
    """The function in fp64: (its output (B,1,Hq,hd), the allowance of
    each element beyond one rounding of the output)."""
    B, _, Hq, hd = q.shape
    G = kc.shape[2]
    qg = q.reshape(B, G, Hq // G, hd).to(kc.dtype).double()
    s = torch.einsum("bgmh,btgh->bgmt", qg, kc.double()) * scale
    if cap:
        s = cap * torch.tanh(s / cap)
    t = torch.arange(kc.shape[1], device=q.device)
    allow = t[None, :] <= pos[:, None]
    if window is not None:
        allow &= (pos[:, None] - t[None, :]) < window
    p64 = torch.softmax(s.masked_fill(~allow[:, None, None], -torch.inf), -1)
    p = p64.to(kc.dtype).double()
    # one ulp of p where the rounding could go either way
    flip = ((p64 * (1 + EPS)).to(kc.dtype).double()
            - (p64 * (1 - EPS)).to(kc.dtype).double()).abs()
    out = torch.einsum("bgmt,btgh->bgmh", p, vc.double())
    allowance = torch.einsum("bgmt,btgh->bgmh", EPS * p64 + flip,
                             vc.double().abs())
    return out.reshape(B, 1, Hq, hd), allowance.reshape(B, 1, Hq, hd)


def _half_ulp(x, dt):
    """Half an ulp of x in dt (0 for fp32: the allowance covers it)."""
    if dt == torch.float32:
        return torch.zeros_like(x)
    _, e = torch.frexp(x.float())
    return torch.where(x == 0, torch.zeros_like(x),
                       torch.ldexp(torch.ones_like(x), e - 9).double())


def _check(out, q, kc, vc, pos, window, cap, scale):
    exact, allowance = _exact(q, kc, vc, pos, window, cap, scale)
    excess = (out.double() - exact).abs() - _half_ulp(exact, out.dtype)
    assert float((excess - allowance).max()) <= 0.0
    plain = ref.decode_attention_ref(q, kc, vc, pos, window=window,
                                     logit_softcap=cap, scale=scale)
    gap = (out.double() - plain.double()).abs()
    assert float((gap - 2 * allowance - 2 * _half_ulp(exact, out.dtype)
                  ).max()) <= 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,g", HEADS)
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
def test_kernel_matches_plain(hd, hq, g, dtype, b):
    """On the card, every head-dim and head layout the served configs use,
    ragged positions, each mask: one launch a call, the exact function
    within the allowance (module docstring)."""
    _need_card()
    dt = getattr(torch, dtype)
    q, kc, vc = _inputs(b, hq, g, hd, dt, seed=hd + hq + g + b)
    pos = _positions(b, g, hq // g)
    for window, cap in MASKS:
        before = ops.decode_attention.launches
        out = ops.decode_attention(q, kc, vc, pos, window=window,
                                   logit_softcap=cap, scale=hd ** -0.5)
        assert ops.decode_attention.launches == before + 1
        assert out.shape == q.shape and out.dtype == dt
        _check(out, q, kc, vc, pos, window, cap, hd ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("hq,g,hd", [(32, 32, 128), (16, 4, 256),
                                     (16, 2, 128), (16, 1, 32)])
def test_bf16_cache_with_fp32_output_rounds_p(hq, g, hd):
    """q and the output in fp32 against a bf16 cache: q rounded to bf16,
    and p's rounding to bf16 shows in the output, which is not rounded
    again.  (16, 1) is a reduced config's one group: 16 rows, two row
    slices."""
    _need_card()
    q, kc, vc = _inputs(8, hq, g, hd, torch.bfloat16, seed=3)
    q = q.float() * 1.5
    pos = _positions(8, g, hq // g)
    for window, cap in MASKS:
        out = ops.decode_attention(q, kc, vc, pos, window=window,
                                   logit_softcap=cap, scale=hd ** -0.5)
        assert out.dtype == torch.float32
        _check(out, q, kc, vc, pos, window, cap, hd ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,g,hd", [(8, 32, 32, 128), (1, 16, 4, 256),
                                       (8, 64, 8, 128)])
def test_rerun_is_bit_for_bit(b, hq, g, hd):
    """No atomics: two runs on the same inputs agree bit for bit."""
    _need_card()
    q, kc, vc = _inputs(b, hq, g, hd, torch.bfloat16, seed=5)
    pos = _positions(b, g, hq // g)
    kw = dict(window=4096, logit_softcap=50.0, scale=hd ** -0.5)
    first = ops.decode_attention(q, kc, vc, pos, **kw)
    assert torch.equal(first, ops.decode_attention(q, kc, vc, pos, **kw))


@pytest.mark.cuda
def test_the_kernel_reads_the_cache_view_in_place():
    """A layer's view of the stacked cache, as the model passes it: no
    copy, the same output as from a contiguous copy, and the cache's
    storage left as it was."""
    _need_card()
    q, kc, vc = _inputs(2, 16, 4, 128, torch.bfloat16, seed=7)
    stacked = torch.stack([kc, vc, kc])        # (3, B, T, G, hd)
    pos = torch.tensor([T - 1, 100], device="cuda")
    kw = dict(scale=128 ** -0.5)
    before = stacked.clone()
    out = ops.decode_attention(q, stacked[0], stacked[1], pos, **kw)
    assert torch.equal(out, ops.decode_attention(q, kc, vc, pos, **kw))
    assert torch.equal(stacked, before)


@pytest.mark.cuda
def test_a_decode_step_launches_once_a_layer():
    """A reduced deepseek-7b's greedy generation on the card: each decode
    step adds exactly n_layers to `decode_attention.launches`."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.runtime.serve_step import greedy_generate
    cfg = get_config("deepseek-7b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0), "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    steps = 3
    before = ops.decode_attention.launches
    out = greedy_generate(model, params, {"tokens": tokens}, steps + 1,
                          24 + steps + 1)
    assert out.shape == (2, steps + 1)
    assert ops.decode_attention.launches - before == steps * cfg.n_layers


@pytest.mark.cuda
def test_dtensors_on_the_card_run_the_kernel(monkeypatch):
    """DTensors on a 1x1 mesh on the card, the cache split over the batch
    and its groups: the kernel shard by shard, never the plain version,
    the output bit for bit the kernel's on the plain tensors.  A cache
    split over its sequence raises: the kernel reduces over it."""
    _need_card()
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_host_mesh
    q, kc, vc = _inputs(8, 32, 32, 128, torch.bfloat16, seed=11)
    pos = _positions(8, 32, 1)
    kw = dict(window=4096, logit_softcap=50.0, scale=128 ** -0.5)
    want = ops.decode_attention(q, kc, vc, pos, **kw)

    def refuse(*args, **kwargs):
        raise AssertionError("a DTensor on the card took the plain version")

    monkeypatch.setattr(ops, "decode_attention_ref", refuse)
    assert not dist.is_initialized()
    mesh = make_host_mesh("cuda")
    try:
        def split(x, *pl):
            return distribute_tensor(x, mesh, list(pl), src_data_rank=None)

        dq = split(q, Shard(0), Replicate())
        before = ops.decode_attention.launches
        got = ops.decode_attention(dq, split(kc, Shard(0), Shard(2)),
                                   split(vc, Shard(0), Shard(2)), pos, **kw)
        assert ops.decode_attention.launches == before + 1
        assert torch.equal(got.full_tensor(), want)
        with pytest.raises(ValueError, match="on mesh dim 1"):
            ops.decode_attention(dq, split(kc, Shard(0), Shard(1)),
                                 split(vc, Shard(0), Shard(1)), pos, **kw)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_raises_under_autograd():
    _need_card()
    q, kc, vc = _inputs(1, 16, 4, 64, torch.float32, seed=9)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention(q, kc, vc, torch.tensor([5], device="cuda"),
                             scale=0.125)
